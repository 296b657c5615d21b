"""``bf16-mixed`` training against the JAX package's, on the CPU: the
``tiny`` preset, the same weights through ``io/from_jax.py``, batches from a
numpy seed, dropout off.

The JAX step is ``_build_step_fn``'s (params and float batch entries cast to
bf16 inside the loss, f32 gradients, clip and Adam) with the CFM draws ``t``
and ``z`` injected, drawn in f32 and cast to bf16 as the JAX model casts the
draws it makes itself: ``make_train_step`` draws them with threefry inside the
step, whose bits PyTorch cannot reproduce.

Tolerances are the JAX package's own for this switch
(``tests/test_training.py::test_bf16_mixed_precision_step``): the loss within
rtol 0.05, the parameters after one Adam step within 1e-3 and still f32.
Neither separates bf16 from f32 (Adam's first update moves each parameter by
at most lr = 1e-4 whatever the gradient), so the gradients are held leaf by
leaf against JAX's bf16-mixed ``value_and_grad`` on the same draws.  Two bf16
implementations round at other points (XLA rounds at the edges of its
fusions, PyTorch after every operation), so the relative L2 error of a leaf
is ~3.5 % at the median and up to 23 % on the duration predictor's leaves,
while f32 gradients lie ~7.4 % at the median from JAX's bf16 ones.  The
bounds sit between (readings on this tiny preset): every leaf within 0.5
(a leaf without its gradient is at 1.0), the median within 0.05, and at least
three leaves in four closer to JAX's bf16 gradient than to its f32 one
(measured 88 %); the port's f32 gradients must miss the last two.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emojivoice_tpu import config as jax_cfglib
from emojivoice_tpu.training import state as jax_state
from emojivoice_tpu.utils.trees import cast_floats
from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.io.from_jax import matcha_state_dict_from_flax
from emojivoice_tpu_torch.training import state as port_state
from emojivoice_tpu_torch.training.train import main
from emojivoice_tpu_torch.utils.prng import training_draws
from tests.test_torch_train_cli import _args, _records, corpus  # noqa: F401  (corpus is a fixture)
from tests.test_torch_training import CFG, _batch, _jargs, _port, _targs, pair  # noqa: F401  (pair is a fixture)

torch.set_num_threads(2)

BF16 = torch.bfloat16
OPT = cfglib.OptimizerConfig()
LEAF_TOL, MEDIAN_TOL, CLOSER_SHARE = 0.5, 0.05, 0.75


def _jax_step(model, params, b, precision):
    """One JAX step, _build_step_fn's casts, the draws injected → (params, loss, gradients)."""
    dtype = jax_state._dtype_for(precision)
    tx = jax_state.make_optimizer(jax_cfglib.OptimizerConfig(**dataclasses.asdict(OPT)))

    @jax.jit
    def step(p, args, t, z):
        def loss_fn(pp):
            if dtype != jnp.float32:
                pp, args_c = cast_floats(pp, dtype), cast_floats(args, dtype)
            else:
                args_c = args
            dur, prior, diff, _ = model.apply(pp, *args_c, rng=jax.random.PRNGKey(0), deterministic=True,
                                              t=t.astype(dtype), z=z.astype(dtype))
            return dur + prior + diff
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(g["params"], tx.init(p["params"]), p["params"])
        return {"params": optax.apply_updates(p["params"], updates)}, loss, g

    new, loss, g = jax.device_get(step(params, _jargs(b), jnp.asarray(b["t"]), jnp.asarray(b["z"])))
    return (matcha_state_dict_from_flax(new, CFG, buffers=False), float(loss),
            matcha_state_dict_from_flax(g, CFG, buffers=False))


def _port_step(params, b, precision):
    """One port step, ``train_step``'s loss and update with the draws injected, dropout off
    → (model, loss, batch, gradients before the clip)."""
    state = port_state.create_train_state(CFG, OPT, model=_port(params), device="cpu")
    x, xl, y, yl, spks = _targs(b)
    batch = {"x": x, "x_lengths": xl, "y": y, "y_lengths": yl, "spks": spks}
    draws = {"t": torch.from_numpy(b["t"]), "z": torch.from_numpy(b["z"])}
    dur, prior, diff = port_state._losses(state.model, batch, draws, None, precision)
    loss = dur + prior + diff
    loss.backward()
    grads = {name: None if p.grad is None else p.grad.detach().clone().numpy()
             for name, p in state.model.named_parameters()}
    port_state.apply_gradients(state)
    return state.model, float(loss.detach()), batch, grads


@pytest.fixture(scope="module")
def steps(pair):  # noqa: F811
    """One step from the same weights, batch and draws: JAX bf16-mixed and f32, the port bf16-mixed and f32."""
    model, params = pair
    b = _batch(3)
    return dict(b=b, jax=_jax_step(model, params, b, "bf16-mixed"), jax32=_jax_step(model, params, b, "f32"),
                port=_port_step(params, b, "bf16-mixed"), port32=_port_step(params, b, "f32"))


def test_bf16_mixed_step_matches_jax_and_f32(pair, steps):  # noqa: F811
    model, params = pair
    b = steps["b"]
    theirs, loss_j, _ = steps["jax"]
    ours, loss_p, batch, _ = steps["port"]
    f32, loss_32, _, _ = steps["port32"]
    assert np.isfinite(loss_p)
    np.testing.assert_allclose(loss_p, loss_j, rtol=0.05)
    np.testing.assert_allclose(loss_p, loss_32, rtol=0.05)
    assert loss_p != loss_32  # the bf16 compute really ran
    moved = 0.0
    for (name, p), q in zip(ours.named_parameters(), f32.parameters()):
        assert p.dtype == torch.float32, name
        assert float(np.abs(p.detach().numpy() - theirs[name]).max()) < 1e-3, name
        assert float((p.detach() - q.detach()).abs().max()) < 1e-3, name
        moved = max(moved, float((p.detach() - torch.from_numpy(np.asarray(
            matcha_state_dict_from_flax(params, CFG, buffers=False)[name]))).abs().max()))
    assert moved > 5e-5  # the step moved the weights

    # eval_step casts the same way: against the JAX loss on the port's own eval draws
    draws = training_draws(0, 0, b["y"].shape[0], b["y"].shape[1], CFG.n_feats, "cpu")
    ev = port_state.eval_step(_port(params), batch, precision="bf16-mixed")
    ev32 = port_state.eval_step(_port(params), batch)

    @jax.jit
    def jeval(p, args, t, z):
        bf = jnp.bfloat16
        dur, prior, diff, _ = model.apply(cast_floats(p, bf), *cast_floats(args, bf), rng=jax.random.PRNGKey(0),
                                          deterministic=True, t=t.astype(bf), z=z.astype(bf))
        return dur + prior + diff
    ref = float(jeval(params, _jargs(b), jnp.asarray(draws["t"].numpy()), jnp.asarray(draws["z"].numpy())))
    np.testing.assert_allclose(float(ev["loss"]), ref, rtol=0.05)
    np.testing.assert_allclose(float(ev["loss"]), float(ev32["loss"]), rtol=0.05)
    assert float(ev["loss"]) != float(ev32["loss"])


def _rel_l2(grads, ref):
    return {name: float(np.linalg.norm(grads[name] - r) / np.linalg.norm(r)) for name, r in ref.items()}


def test_bf16_mixed_gradients_match_jax(steps):
    """The gradients the bf16-mixed loss leaves on the f32 parameters (through
    the differentiable casts of ``functional_call``), leaf by leaf against
    JAX's bf16-mixed gradients; the bounds must reject the port's f32 ones."""
    _, _, jax16 = steps["jax"]
    _, _, jax32 = steps["jax32"]
    grads, grads32 = steps["port"][3], steps["port32"][3]
    assert sorted(grads) == sorted(jax16)
    dead = [name for name, g in grads.items() if g is None or not np.abs(g).max() > 0]
    assert not dead, dead  # every float parameter gets a gradient
    assert all(g.dtype == np.float32 for g in grads.values())

    def verdict(g):
        err, err32 = _rel_l2(g, jax16), _rel_l2(g, jax32)
        closer = float(np.mean([err[n] < err32[n] for n in err]))
        return err, float(np.median(list(err.values()))), closer

    err, median, closer = verdict(grads)
    worst = max(err, key=err.get)
    assert err[worst] <= LEAF_TOL, (worst, err[worst])
    assert median <= MEDIAN_TOL and closer >= CLOSER_SHARE, (median, closer)
    _, median32, closer32 = verdict(grads32)  # f32 gradients: the same bounds tell them apart
    assert median32 > MEDIAN_TOL and closer32 < CLOSER_SHARE, (median32, closer32)


def test_precision_names():
    for name in ("bf16-mixed", "bf16", "16-mixed"):
        assert port_state._dtype_for(name) == BF16 == {jnp.bfloat16: BF16}[jax_state._dtype_for(name)]
    for name in ("f32", "fp32", "32", "32-true", None):
        assert port_state._dtype_for(name) == torch.float32
    for name in ("fp16", "16", "bf16-true", "64"):
        with pytest.raises(ValueError, match="Unknown precision"):
            port_state._dtype_for(name)
        with pytest.raises(ValueError, match="Unknown precision"):
            jax_state._dtype_for(name)


def test_trainer_cli_bf16_mixed(corpus, tmp_path, monkeypatch):  # noqa: F811
    seen = []
    real = port_state.train_step
    monkeypatch.setattr(port_state, "train_step", lambda *a, **kw: seen.append(kw.get("precision")) or real(*a, **kw))
    out = tmp_path / "bf16"
    assert main(_args(corpus, out, "--fast_dev_run", "--precision", "bf16-mixed")) == 0
    train, val = _records(out, "train"), _records(out, "val")
    assert seen == ["bf16-mixed"] and [r["step"] for r in train] == [1] and len(val) == 1
    assert all(np.isfinite(train[0][k]) for k in ("loss", "dur_loss", "prior_loss", "diff_loss", "grad_norm"))
    assert train[0]["grad_norm"] > 0 and np.isfinite(val[0]["loss"])
    with pytest.raises(SystemExit):
        main(_args(corpus, tmp_path / "bad", "--fast_dev_run", "--precision", "fp16"))


def test_bf16_mixed_train_step_updates_the_f32_batch_stats():
    """``train_step(precision="bf16-mixed")`` on a conformer decoder: the
    BatchNorm buffers stay f32 on the module and take the update (a cast copy
    would swallow it), within bf16's rounding of the f32 step's update."""
    from tests.test_torch_training import _bn_buffers, _conformer_state

    b = _batch(21)
    batch = dict(zip(("x", "x_lengths", "y", "y_lengths", "spks"), _targs(b)))
    after = {}
    for precision in ("f32", "bf16-mixed"):
        state = _conformer_state()
        start = _bn_buffers(state.model)
        port_state.train_step(state, batch, seed=3, precision=precision)
        after[precision] = _bn_buffers(state.model)
        for k, v in after[precision].items():
            if "running" in k:
                assert v.dtype == torch.float32 and not torch.equal(v, start[k]), k
    for k, v in after["bf16-mixed"].items():
        if "running" in k:
            assert not torch.equal(v, after["f32"][k]), k  # bf16 arithmetic really ran
            np.testing.assert_allclose(v.numpy(), after["f32"][k].numpy(), rtol=2e-2, atol=2e-3, err_msg=k)
