"""The port's training path against the JAX package on the CPU: the ``tiny``
preset, the same weights through ``io/from_jax.py``, inputs from a numpy seed,
the CFM draws ``t``/``z`` injected into both, dropout off (``eval()`` here,
``deterministic=True`` there).

Tolerances, each with its reason:
* ``attn`` equal — MAS paths are binary.  A seed that put MAS on a near-tie
  (the log-priors differ by f32 rounding between XLA and PyTorch) would have
  to be replaced, not tolerated; seed 0 is clear of ties.
* losses rtol 1e-4, the bound ``tests/test_training_parity.py`` uses;
* gradients: per tensor, max-abs difference ≤ 1e-4 · that tensor's max-abs
  gradient + 1e-6 (f32 summation order);
* three optimizer steps: metrics rtol 1e-3, parameters atol 3e-4.  Adam's
  first steps move every element by about lr = 1e-4 whatever its gradient's
  size, so an element whose tiny gradient rounds differently can differ by
  up to lr per step: three steps, 3e-4.
* probe scalars rtol 1e-4; schedules rtol 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emojivoice_tpu import config as jax_cfglib
from emojivoice_tpu.models import MatchaTTS as FlaxMatcha
from emojivoice_tpu.training import state as jax_state
from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.io.from_jax import load_adam_state_from_optax, matcha_state_dict_from_flax
from emojivoice_tpu_torch.models.matcha import MatchaTTS
from emojivoice_tpu_torch.training import state as port_state

torch.set_num_threads(2)

B, TX, TY = 2, 16, 32
CFG = cfglib.get_preset("tiny").model
JCFG = jax_cfglib.get_preset("tiny").model


def _batch(seed):
    rng = np.random.default_rng(seed)
    xl, yl = np.array([16, 11], np.int32), np.array([32, 27], np.int32)
    x = np.zeros((B, TX), np.int32)
    y = np.zeros((B, TY, CFG.n_feats), np.float32)
    for i in range(B):
        x[i, : xl[i]] = rng.integers(1, 170, xl[i])
        y[i, : yl[i]] = rng.normal(size=(yl[i], CFG.n_feats)).astype(np.float32)
    return {"x": x, "x_lengths": xl, "y": y, "y_lengths": yl, "spks": np.array([1, 3], np.int32),
            "t": rng.uniform(size=(B, 1, 1)).astype(np.float32),
            "z": rng.normal(size=(B, TY, CFG.n_feats)).astype(np.float32)}


def _jargs(b):
    return tuple(jnp.asarray(b[k]) for k in ("x", "x_lengths", "y", "y_lengths", "spks"))


def _targs(b):
    return tuple(torch.from_numpy(b[k]).long() if b[k].dtype == np.int32 else torch.from_numpy(b[k])
                 for k in ("x", "x_lengths", "y", "y_lengths", "spks"))


@pytest.fixture(scope="module")
def pair():
    model = FlaxMatcha(cfg=JCFG)
    init = jax.jit(lambda rng: model.init(
        {"params": rng}, jnp.ones((1, 8), jnp.int32), jnp.array([8]), 16, 1, 1.0, jnp.array([0]), 1.0, None,
        jnp.zeros((1, 16, JCFG.n_feats)), method=FlaxMatcha.synthesise))
    params = jax.device_get(init(jax.random.PRNGKey(0)))
    # flax starts the prenet's projection, every bias and SnakeBeta's α, β at
    # zero: move them off zero so that no gradient path is switched off
    rng = np.random.default_rng(42)
    params = jax.tree.map(lambda a: np.asarray(a + 0.05 * rng.normal(size=a.shape), np.float32), params)
    return model, params


def _port(params):
    port = MatchaTTS(CFG)
    port.load_state_dict({k: torch.tensor(v) for k, v in matcha_state_dict_from_flax(params, CFG).items()},
                         strict=True)
    return port.eval()


@functools.lru_cache(maxsize=None)
def _jax_forward(model, out_size, with_rows):
    def fwd(params, args, t, z, row_mask, rng):
        return model.apply(params, *args, out_size=out_size, rng=rng, deterministic=True,
                           row_mask=row_mask if with_rows else None, t=t, z=z)
    return jax.jit(fwd)


def _assert_losses_close(ours, theirs):
    np.testing.assert_array_equal(ours[3].numpy(), np.asarray(theirs[3]))  # attn
    for name, a, b in zip(("dur", "prior", "diff"), ours[:3], theirs[:3]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("with_rows", [False, True], ids=["all_rows", "row_mask"])
def test_forward_matches_jax(pair, with_rows):
    model, params = pair
    b = _batch(0)
    rows = np.array([1.0, 0.0], np.float32)
    theirs = _jax_forward(model, None, with_rows)(params, _jargs(b), jnp.asarray(b["t"]), jnp.asarray(b["z"]),
                                                  jnp.asarray(rows), jax.random.PRNGKey(0))
    with torch.no_grad():
        ours = _port(params)(*_targs(b), t=torch.from_numpy(b["t"]), z=torch.from_numpy(b["z"]),
                             row_mask=torch.from_numpy(rows) if with_rows else None)
    _assert_losses_close(ours, theirs)
    assert float(ours[3].sum()) == float(b["y_lengths"].sum())  # one text position per mel frame


def test_forward_with_segment_crop_matches_jax(pair):
    """out_size = 16 < T_y: the crop offsets are the JAX draw, recomputed here
    the way ``MatchaTTS.__call__`` and ``_segment_crop`` draw them, and passed
    to the port, so both crop the same frames."""
    model, params = pair
    b, out_size = _batch(1), 16
    z = b["z"][:, :out_size]
    rng = jax.random.PRNGKey(5)
    theirs = _jax_forward(model, out_size, False)(params, _jargs(b), jnp.asarray(b["t"]), jnp.asarray(z),
                                                  None, rng)
    u = np.array(jax.random.uniform(jax.random.split(rng)[1], (B,)))
    port = _port(params)
    offsets = port.crop_offsets_from_uniform(torch.from_numpy(u), torch.from_numpy(b["y_lengths"]).long(), out_size)
    want = np.floor(u * np.maximum(b["y_lengths"] - out_size, 0)).astype(np.int64)
    np.testing.assert_array_equal(offsets.numpy(), want)
    assert want.max() > 0  # the crop really moves
    with torch.no_grad():
        ours = port(*_targs(b), t=torch.from_numpy(b["t"]), z=torch.from_numpy(z), out_size=out_size,
                    crop_offsets=offsets)
    assert ours[3].shape == (B, TX, out_size)
    _assert_losses_close(ours, theirs)


def test_gradients_match_jax(pair):
    model, params = pair
    b = _batch(2)

    def total(p):
        dur, prior, diff, _ = model.apply(p, *_jargs(b), rng=jax.random.PRNGKey(0), deterministic=True,
                                          t=jnp.asarray(b["t"]), z=jnp.asarray(b["z"]))
        return dur + prior + diff
    grads = jax.device_get(jax.jit(jax.grad(total))(params))
    theirs = matcha_state_dict_from_flax(grads, CFG, buffers=False)

    port = _port(params)
    dur, prior, diff, _ = port(*_targs(b), t=torch.from_numpy(b["t"]), z=torch.from_numpy(b["z"]))
    (dur + prior + diff).backward()
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(theirs)
    for name, p in named.items():
        g, ref = p.grad.numpy(), theirs[name]
        bound = 1e-4 * np.abs(ref).max() + 1e-6
        assert np.abs(g - ref).max() <= bound, f"{name}: {np.abs(g - ref).max()} over {bound}"
    assert sum(float(np.abs(v).max()) > 0 for v in theirs.values()) == len(theirs)  # no dead tensor


def test_three_optimizer_steps_match_jax(pair):
    """Both optimizers start from the same non-zero Adam state (one optax
    step from the initial weights, carried across by ``io/from_jax.py``) and
    take three steps on the same batches and draws."""
    model, params = pair
    opt_cfg = dataclasses.replace(cfglib.OptimizerConfig(), scheduler="cosine", warmup_steps=2, decay_steps=10,
                                  grad_clip=0.5)  # a clip that bites: the norms here are over 0.5
    jopt_cfg = jax_cfglib.OptimizerConfig(**dataclasses.asdict(opt_cfg))
    tx = jax_state.make_optimizer(jopt_cfg)
    sched = jax_state.make_schedule(jopt_cfg)

    @jax.jit
    def jstep(p, opt_state, args, t, z):
        def loss_fn(pp):
            dur, prior, diff, _ = model.apply(pp, *args, rng=jax.random.PRNGKey(0), deterministic=True, t=t, z=z)
            return dur + prior + diff, (dur, prior, diff)
        (total, (dur, prior, diff)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, opt_state = tx.update(g["params"], opt_state, p["params"])
        new = {"params": optax.apply_updates(p["params"], updates)}
        return new, opt_state, {"loss": total, "dur_loss": dur, "prior_loss": prior, "diff_loss": diff,
                                "grad_norm": optax.global_norm(g["params"])}

    def jrun(p, opt_state, b):
        return jstep(p, opt_state, _jargs(b), jnp.asarray(b["t"]), jnp.asarray(b["z"]))

    p1, opt1, _ = jrun(params, tx.init(params["params"]), _batch(10))
    p1, opt1 = jax.device_get(p1), jax.device_get(opt1)
    adam = opt1[1][0]  # chain(clip, adam): (EmptyState, (ScaleByAdamState, ...))
    assert int(adam.count) == 1

    state = port_state.create_train_state(CFG, opt_cfg, model=_port(p1), device="cpu")
    load_adam_state_from_optax(state.optimizer, state.model, adam.mu, adam.nu, int(adam.count), CFG)
    state.step = 1

    jp, jopt = p1, opt1
    for i in range(3):
        b = _batch(11 + i)
        jp, jopt, jm = jrun(jp, jopt, b)
        dur, prior, diff, _ = state.model(*_targs(b), t=torch.from_numpy(b["t"]), z=torch.from_numpy(b["z"]))
        state.optimizer.zero_grad(set_to_none=True)
        (dur + prior + diff).backward()
        grad_norm, lr = port_state.apply_gradients(state)
        ours = {"loss": dur + prior + diff, "dur_loss": dur, "prior_loss": prior, "diff_loss": diff,
                "grad_norm": grad_norm}
        for k, v in ours.items():
            np.testing.assert_allclose(float(v.detach()), float(jm[k]), rtol=1e-3, err_msg=f"step {i} {k}")
        assert float(jm["grad_norm"]) > opt_cfg.grad_clip
        np.testing.assert_allclose(lr, float(sched(1 + i)), rtol=1e-6)
    assert state.step == 4
    theirs = matcha_state_dict_from_flax(jax.device_get(jp), CFG, buffers=False)
    start = matcha_state_dict_from_flax(p1, CFG, buffers=False)
    moved = 0.0
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), theirs[name], atol=3e-4, rtol=0, err_msg=name)
        moved = max(moved, float(np.abs(theirs[name] - start[name]).max()))
    assert moved > 5e-5  # the steps did move the weights


def test_adamw_and_clip_follow_optax():
    """One update of a small tensor set through the port's optimizer and
    clip against ``optax.chain(clip_by_global_norm, adamw)``."""
    rng = np.random.default_rng(3)
    ps = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    gs = [(10 * rng.normal(size=p.shape)).astype(np.float32) for p in ps]
    cfg = dataclasses.replace(cfglib.OptimizerConfig(), weight_decay=0.01, lr=1e-2, grad_clip=1.0)
    tx = jax_state.make_optimizer(jax_cfglib.OptimizerConfig(**dataclasses.asdict(cfg)))
    updates, _ = tx.update([jnp.asarray(g) for g in gs], tx.init([jnp.asarray(p) for p in ps]),
                           [jnp.asarray(p) for p in ps])
    want = optax.apply_updates([jnp.asarray(p) for p in ps], updates)

    tps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in ps]
    for p, g in zip(tps, gs):
        p.grad = torch.from_numpy(g.copy())
    opt = port_state.make_optimizer(tps, cfg)
    assert isinstance(opt, torch.optim.AdamW)
    norm = port_state.clip_by_global_norm_(tps, cfg.grad_clip)
    np.testing.assert_allclose(float(norm), np.sqrt(sum(float((g ** 2).sum()) for g in gs)), rtol=1e-6)
    opt.step()
    for p, w in zip(tps, want):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    # below the bound the clip leaves the gradients alone
    small = [torch.nn.Parameter(torch.zeros(3))]
    small[0].grad = torch.tensor([0.1, 0.2, 0.2])
    port_state.clip_by_global_norm_(small, 1.0)
    np.testing.assert_allclose(small[0].grad.numpy(), [0.1, 0.2, 0.2], rtol=1e-6)


def test_training_probe_matches_jax(pair):
    model, params = pair
    b = _batch(4)
    rng = jax.random.PRNGKey(0)
    probe = jax.jit(lambda p, args: model.apply(p, *args, method=FlaxMatcha.training_probe, n_timesteps=2,
                                                rng=rng))
    theirs = jax.device_get(probe(params, _jargs(b)))
    z = np.asarray(jax.random.normal(rng, b["y"].shape, jnp.float32) * 0.667)  # CFM.__call__'s draw
    ours = _port(params).training_probe(*_targs(b), n_timesteps=2, z=torch.from_numpy(z))
    assert sorted(ours) == sorted(theirs)
    np.testing.assert_array_equal(ours["mas_durations"].numpy(), theirs["mas_durations"])
    for k in theirs:
        if k != "mas_durations":
            np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("kind", ["constant", "exponential", "cosine"])
@pytest.mark.parametrize("warmup", [0, 50])
def test_schedule_matches_optax(kind, warmup):
    kw = dict(lr=2e-4, scheduler=kind, warmup_steps=warmup, decay_steps=1000, scheduler_gamma=0.5, lr_end=1e-5)
    ours = port_state.make_schedule(cfglib.OptimizerConfig(**kw))
    theirs = jax_state.make_schedule(jax_cfglib.OptimizerConfig(**kw))
    for step in (0, 1, max(warmup - 1, 0), warmup, warmup + 1, 500, 1000 + warmup, 10 ** 6):
        want = float(theirs(step)) if callable(theirs) else float(theirs)
        np.testing.assert_allclose(ours(step), want, rtol=1e-6, atol=1e-12, err_msg=f"step {step}")


def test_unknown_scheduler_raises():
    with pytest.raises(ValueError, match="Unknown scheduler"):
        port_state.make_schedule(cfglib.OptimizerConfig(scheduler="step"))


def _conformer_state(seed=0):
    cfg = dataclasses.replace(CFG, decoder=dataclasses.replace(CFG.decoder, down_block_type="conformer",
                                                               mid_block_type="conformer", up_block_type="conformer"))
    return port_state.create_train_state(cfg, cfglib.OptimizerConfig(), seed=seed, device="cpu")


def _bn_buffers(model):
    return {k: v.clone() for k, v in model.state_dict().items() if ".conv.net.5." in k}


def test_train_step_threads_conformer_batch_stats():
    """``train_step`` (dropout and draws seeded from the step) updates the
    BatchNorm buffers of a conformer decoder in place, the same way from the
    same state; ``eval_step`` reads them only; the state dict carries them."""
    b = _batch(20)
    batch = dict(zip(("x", "x_lengths", "y", "y_lengths", "spks"), _targs(b)))
    runs = []
    for _ in range(2):
        state = _conformer_state()
        start = _bn_buffers(state.model)
        port_state.eval_step(state.model, batch)
        assert all(torch.equal(v, start[k]) for k, v in _bn_buffers(state.model).items())
        port_state.train_step(state, batch, seed=3)
        runs.append(_bn_buffers(state.model))
        moved = [k for k, v in runs[-1].items() if "running" in k and not torch.equal(v, start[k])]
        assert len(moved) == 2 * 5, moved  # mean and variance of the five blocks
        assert all(int(v) == 1 for k, v in runs[-1].items() if k.endswith("num_batches_tracked"))
        saved = state.state_dict()["model"]
        assert all(torch.equal(saved[k], v) for k, v in runs[-1].items())
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
