"""The port's conformer block (``models/conformer.py``), the U-Net built of
it, ``strict_mask``, and the conformer model's synthesis and training step,
against the JAX package on the CPU: the same weights through
``io/from_jax.py`` (BatchNorm statistics from ``batch_stats``, made non-trivial
here), inputs from a numpy seed, the CFM draws injected.

Tolerances, each with its reason (f32 summation order between XLA and
PyTorch's CPU kernels unless said):
* one block, eval mode, with a mask: atol 1e-5, at max_pos_emb 512 and at 8
  with T = 24 (distances clamped);
* one block, train mode: output and the updated BatchNorm statistics against
  JAX's ``mutable=["batch_stats"]`` apply within 1e-6 (the output relative to
  its largest value: it leaves a LayerNorm at unit scale);
* the U-Net and synthesis: mel MAE below 1e-4 at the tiny config and 1e-3 at
  emoji_multi width, lengths equal (``tests/test_torch_matcha.py``'s bounds),
  with ``strict_mask`` on a U-Net that mixes block types;
* one training step: gradients per tensor within 1e-4 of that tensor's
  largest + 1e-6, Adam moments likewise, BatchNorm buffers within 1e-6
  (``tests/test_torch_training.py``'s bounds);
* bf16 (compute dtype, and the BatchNorm update under ``bf16-mixed``): the
  PR 7 bounds, mel MAE 0.1 and lengths within 2 frames, the loss within rtol
  0.05, the updated statistics within bf16's rounding (rtol 1e-2).
Whole tensors are compared, padded frames included: the conformer's quirks
(uniform attention of masked query rows, padded frames in the conv halo and
the statistics) are part of what is held.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emojivoice_tpu import config as jax_cfglib
from emojivoice_tpu.models import MatchaTTS as FlaxMatcha
from emojivoice_tpu.models.conformer import ConformerBlock as FlaxBlock
from emojivoice_tpu.models.decoder import Decoder as FlaxDecoder
from emojivoice_tpu.training import state as jax_state
from emojivoice_tpu.utils.trees import cast_floats
from emojivoice_tpu_torch.io.from_jax import conformer_block_state_dict_from_flax, matcha_state_dict_from_flax
from emojivoice_tpu_torch.models.conformer import BatchNorm, ConformerBlock
from emojivoice_tpu_torch.models.matcha import MatchaTTS
from emojivoice_tpu_torch.training import state as port_state
from tests.test_models import tiny_cfg

torch.set_num_threads(2)

ALL = ("conformer", "conformer", "conformer")
MIXED = ("transformer", "conformer", "transformer")


def with_blocks(cfg, kinds, dropout_free=False):
    dec = dataclasses.replace(cfg.decoder, down_block_type=kinds[0], mid_block_type=kinds[1],
                              up_block_type=kinds[2])
    cfg = dataclasses.replace(cfg, decoder=dec)
    if dropout_free:  # train mode then differs from eval mode in BatchNorm alone
        cfg = dataclasses.replace(
            cfg, encoder=dataclasses.replace(cfg.encoder, p_dropout=0.0, prenet=False),
            duration_predictor=dataclasses.replace(cfg.duration_predictor, p_dropout=0.0),
            decoder=dataclasses.replace(cfg.decoder, dropout=0.0))
    return cfg


def moved(variables, seed):
    """Parameters moved off their init (zero biases, unit scales) and
    BatchNorm statistics made non-trivial, so that every path is exercised."""
    rng = np.random.default_rng(seed)
    out = dict(variables)
    out["params"] = jax.tree.map(lambda a: np.asarray(a + 0.05 * rng.normal(size=a.shape), np.float32),
                                 variables["params"])
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree.map(
            lambda a: np.asarray(0.3 * rng.normal(size=a.shape) if np.all(np.asarray(a) == 0)
                                 else rng.uniform(0.5, 1.5, size=a.shape), np.float32), variables["batch_stats"])
    return out


def matcha_pair(cfg, seed=0, strict_mask=False):
    model = FlaxMatcha(cfg=cfg, strict_mask=strict_mask)
    init = jax.jit(lambda rng: model.init(
        {"params": rng}, jnp.ones((1, 8), jnp.int32), jnp.array([8]), 16, 1, 1.0, jnp.array([0]), 1.0, None,
        jnp.zeros((1, 16, cfg.n_feats)), method=FlaxMatcha.synthesise))
    variables = moved(jax.device_get(init(jax.random.PRNGKey(seed))), seed + 100)
    port = MatchaTTS(cfg, strict_mask=strict_mask)
    port.load_state_dict({k: torch.tensor(v) for k, v in matcha_state_dict_from_flax(variables, cfg).items()},
                         strict=True)
    return model, variables, port.eval()


# --------------------------------------------------------------------------- one block

def block_pair(max_pos_emb, seed=0, dim=16, heads=2, head_dim=8, t=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t, dim)).astype(np.float32)
    mask = np.ones((2, t), np.float32)
    mask[1, 17:] = 0  # a padded tail: masked query rows and keys
    block = FlaxBlock(dim=dim, heads=heads, head_dim=head_dim, max_pos_emb=max_pos_emb)
    variables = moved(jax.device_get(block.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(mask))),
                      seed + 1)
    port = ConformerBlock(dim, heads, head_dim, max_pos_emb=max_pos_emb)
    port.load_state_dict({k: torch.tensor(v) for k, v in conformer_block_state_dict_from_flax(variables).items()},
                         strict=True)
    return block, variables, port, x, mask


@pytest.mark.parametrize("max_pos_emb", [512, 8], ids=["pos512", "clamped_pos8"])
def test_block_matches_jax_in_eval_mode(max_pos_emb):
    block, variables, port, x, mask = block_pair(max_pos_emb)
    ref = np.asarray(block.apply(variables, jnp.asarray(x), jnp.asarray(mask)))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    for k, v in port.state_dict().items():  # eval mode reads the statistics and leaves them alone
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    if max_pos_emb == 8:  # the clamp is really hit: an unclamped table gives another answer
        with torch.no_grad():
            wide = ConformerBlock(16, 2, 8, max_pos_emb=24)
            sd = port.state_dict()
            emb = sd["attn.fn.rel_pos_emb.weight"]
            sd["attn.fn.rel_pos_emb.weight"] = torch.cat([emb[:1].expand(16, -1), emb, emb[-1:].expand(16, -1)])
            wide.load_state_dict(sd, strict=True)
            np.testing.assert_allclose(wide.eval()(torch.from_numpy(x), torch.from_numpy(mask)).numpy(), ref,
                                       atol=1e-5)
            sd["attn.fn.rel_pos_emb.weight"] = torch.randn_like(sd["attn.fn.rel_pos_emb.weight"])
            wide.load_state_dict(sd, strict=True)
            assert np.abs(wide(torch.from_numpy(x), torch.from_numpy(mask)).numpy() - ref).max() > 1e-3


def test_block_train_forward_and_batch_stats_match_jax():
    block, variables, port, x, mask = block_pair(512, seed=3)
    ref, updated = block.apply(variables, jnp.asarray(x), jnp.asarray(mask), deterministic=False,
                               mutable=["batch_stats"])
    ref = np.asarray(ref)
    out = port.train()(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
    bn = port.conv.net[5]
    stats = updated["batch_stats"]["conv"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=0, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    moved_by = np.abs(bn.running_mean.numpy() - variables["batch_stats"]["conv"]["bn"]["mean"]).max()
    assert moved_by > 1e-3  # the update really happened


def test_batchnorm_is_torch_batchnorm_in_f32():
    """The written-out arithmetic computes what ``nn.BatchNorm1d`` does, in
    both modes, the running update included."""
    torch.manual_seed(0)
    ours, theirs = BatchNorm(6), torch.nn.BatchNorm1d(6)
    with torch.no_grad():
        for m in (ours, theirs):
            m.weight.copy_(torch.linspace(0.5, 1.5, 6))
            m.bias.copy_(torch.linspace(-0.2, 0.3, 6))
    x = torch.randn(3, 6, 11) * 2 + 1
    torch.testing.assert_close(ours.train()(x), theirs.train()(x), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ours.running_mean, theirs.running_mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(ours.running_var, theirs.running_var, rtol=1e-6, atol=1e-7)
    assert int(ours.num_batches_tracked) == int(theirs.num_batches_tracked) == 1
    torch.testing.assert_close(ours.eval()(x), theirs.eval()(x), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- the U-Net and synthesis

@pytest.mark.parametrize("kinds,strict_mask", [(ALL, False), (MIXED, True), (MIXED, False)],
                         ids=["conformer", "mixed_strict_mask", "mixed"])
def test_unet_matches_jax(kinds, strict_mask):
    cfg = with_blocks(tiny_cfg(), kinds)
    _, variables, port = matcha_pair(cfg, seed=1, strict_mask=strict_mask)
    n, spk_dim = cfg.n_feats, cfg.spk_emb_dim
    rng = np.random.default_rng(7)
    t_len = 32
    x, mu = (rng.normal(size=(2, t_len, n)).astype(np.float32) for _ in range(2))
    mask = np.ones((2, t_len, 1), np.float32)
    mask[1, 21:] = 0
    t = np.array([0.3, 0.8], np.float32)
    spks = rng.normal(size=(2, spk_dim)).astype(np.float32)
    est = FlaxDecoder(cfg=cfg.decoder, in_channels=2 * n + spk_dim, out_channels=n, strict_mask=strict_mask)
    ref = np.asarray(est.apply(
        {"params": variables["params"]["decoder"]["estimator"],
         **({"batch_stats": variables["batch_stats"]["decoder"]["estimator"]} if "batch_stats" in variables
            else {})},
        *map(jnp.asarray, (x, mask, mu, t, spks))))
    with torch.no_grad():
        out = port.decoder.estimator(*map(torch.from_numpy, (x, mask, mu, t, spks))).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    if kinds == MIXED:  # strict_mask reaches the transformer blocks: the other setting gives another answer
        other = MatchaTTS(cfg, strict_mask=not strict_mask)
        other.load_state_dict(port.state_dict(), strict=True)
        with torch.no_grad():
            alt = other.eval().decoder.estimator(*map(torch.from_numpy, (x, mask, mu, t, spks))).numpy()
        assert np.abs(alt - ref).max() > 1e-4
    if kinds == ALL:  # a conformer U-Net ignores strict_mask
        other = MatchaTTS(cfg, strict_mask=True)
        other.load_state_dict(port.state_dict(), strict=True)
        with torch.no_grad():
            alt = other.eval().decoder.estimator(*map(torch.from_numpy, (x, mask, mu, t, spks))).numpy()
        np.testing.assert_array_equal(alt, out)


def _synth_pair(model, variables, port, cfg, seed, steps=2, ty=48, lengths=(12, 8), spks=(1, 2)):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), 16), np.int64)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.integers(1, 170, n)
    xl, sp = np.asarray(lengths, np.int64), np.asarray(spks, np.int64)
    z = rng.normal(size=(len(lengths), ty, cfg.n_feats)).astype(np.float32) * 0.667
    theirs = jax.device_get(model.apply(variables, jnp.asarray(x, jnp.int32), jnp.asarray(xl, jnp.int32), ty, steps,
                                        0.667, jnp.asarray(sp, jnp.int32), 1.0, None, jnp.asarray(z),
                                        method=FlaxMatcha.synthesise))
    ours = port.synthesise(torch.from_numpy(x), torch.from_numpy(xl), ty, steps, torch.from_numpy(z),
                           torch.from_numpy(sp))
    return ours, theirs


def _assert_mel_close(ours, theirs, bound):
    np.testing.assert_array_equal(ours["mel_lengths"].numpy(), np.asarray(theirs["mel_lengths"]))
    mae = float(np.abs(ours["mel"].numpy() - np.asarray(theirs["mel"])).mean())  # padded frames too
    assert mae < bound, (mae, bound)


@pytest.mark.parametrize("kinds,strict_mask", [(ALL, False), (MIXED, True)], ids=["conformer", "mixed_strict_mask"])
def test_synthesise_matches_jax_tiny(kinds, strict_mask):
    cfg = with_blocks(tiny_cfg(), kinds)
    model, variables, port = matcha_pair(cfg, seed=2, strict_mask=strict_mask)
    _assert_mel_close(*_synth_pair(model, variables, port, cfg, seed=4), 1e-4)


def test_synthesise_matches_jax_at_emoji_multi_width():
    cfg = with_blocks(jax_cfglib.get_preset("emoji_multi").model, ALL)
    model, variables, port = matcha_pair(cfg, seed=5)
    _assert_mel_close(*_synth_pair(model, variables, port, cfg, seed=6, lengths=(14, 10), spks=(79, 107)), 1e-3)


def test_synthesise_in_bf16_follows_jax_bf16():
    """Stage B in bf16, as both pipelines run it with ``compute_dtype=bf16``:
    the encoder in f32, then the decode on a bf16 copy of the conformer model
    (parameters and BatchNorm statistics in bf16) against JAX's ``decode_mel``
    on its variables cast to bf16: the PR 7 bounds."""
    cfg = with_blocks(tiny_cfg(), ALL)
    model, variables, port = matcha_pair(cfg, seed=8)
    rng = np.random.default_rng(9)
    x = np.zeros((2, 16), np.int64)
    x[0, :12], x[1, :9] = rng.integers(1, 170, 12), rng.integers(1, 170, 9)
    xl, sp = np.array([12, 9]), np.array([0, 2])
    z = rng.normal(size=(2, 48, cfg.n_feats)).astype(np.float32) * 0.667
    bf = jnp.bfloat16
    mu_x, w_ceil, y_lengths, x_mask, spk_e = model.apply(variables, jnp.asarray(x, jnp.int32),
                                                         jnp.asarray(xl, jnp.int32), jnp.asarray(sp, jnp.int32),
                                                         1.0, method=FlaxMatcha.encode_text)
    variables16 = cast_floats(jax.tree.map(jnp.asarray, variables), bf)  # jnp leaves: numpy bf16 promotes scalars
    theirs = jax.device_get(model.apply(variables16, mu_x.astype(bf), w_ceil, y_lengths,
                                        x_mask.astype(bf), spk_e.astype(bf), 48, 2, 0.667, None,
                                        jnp.asarray(z, bf), method=FlaxMatcha.decode_mel))
    port16 = MatchaTTS(cfg)
    port16.load_state_dict(port.state_dict(), strict=True)
    port16 = port16.to(torch.bfloat16).eval()
    port16.decoder.estimator.time_mlp.float()  # as the pipeline's bf16 copy keeps it
    assert port16.decoder.estimator.mid_blocks[0][1][0].conv.net[5].running_var.dtype == torch.bfloat16
    with torch.no_grad():
        mu, w, yl, xm, se = port.encode_text(torch.from_numpy(x), torch.from_numpy(xl), torch.from_numpy(sp))
        ours = port16.decode_mel(mu.to(torch.bfloat16), w, yl, xm.to(torch.bfloat16), se.to(torch.bfloat16), 48, 2,
                                 torch.from_numpy(z))
    lengths = np.asarray(theirs["mel_lengths"])
    assert np.abs(ours["mel_lengths"].numpy() - lengths).max() <= 2
    n = int(min(lengths.min(), ours["mel_lengths"].min()))
    mae = float(np.abs(ours["mel"].float().numpy()[:, :n] - np.asarray(theirs["mel"], np.float32)[:, :n]).mean())
    assert mae < 0.1, mae
    f32 = port.decode_mel(mu, w, yl, xm, se, 48, 2, torch.from_numpy(z))["mel"].numpy()[:, :n]
    assert np.abs(ours["mel"].float().numpy()[:, :n] - f32).mean() > 1e-4  # bf16 really ran


# --------------------------------------------------------------------------- training

def _train_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    xl, yl = np.array([16, 11], np.int32), np.array([32, 27], np.int32)
    x = np.zeros((2, 16), np.int32)
    y = np.zeros((2, 32, cfg.n_feats), np.float32)
    for i in range(2):
        x[i, : xl[i]] = rng.integers(1, 170, xl[i])
        y[i, : yl[i]] = rng.normal(size=(yl[i], cfg.n_feats)).astype(np.float32)
    return {"x": x, "x_lengths": xl, "y": y, "y_lengths": yl, "spks": np.array([1, 2], np.int32),
            "t": rng.uniform(size=(2, 1, 1)).astype(np.float32),
            "z": rng.normal(size=(2, 32, cfg.n_feats)).astype(np.float32)}


def _jax_train_step(model, variables, b, cfg, precision="f32"):
    """The JAX training forward (``deterministic=False``: BatchNorm on batch
    statistics, updated through ``mutable``), the casts of ``_build_step_fn``
    and one optax step → (loss, gradients, Adam state, new params, new stats)."""
    dtype = jax_state._dtype_for(precision)
    tx = jax_state.make_optimizer(jax_cfglib.OptimizerConfig())
    args = tuple(jnp.asarray(b[k]) for k in ("x", "x_lengths", "y", "y_lengths", "spks"))

    @jax.jit
    def step(variables, args, t, z):
        def loss_fn(params):
            p, a = (cast_floats(params, dtype), cast_floats(args, dtype)) if dtype != jnp.float32 else (params, args)
            (dur, prior, diff, _), upd = model.apply(p, *a, rng=jax.random.PRNGKey(0), deterministic=False,
                                                     mutable=["batch_stats"], t=t.astype(dtype), z=z.astype(dtype))
            return dur + prior + diff, upd
        (loss, upd), g = jax.value_and_grad(loss_fn, has_aux=True)(variables)
        opt = tx.init(variables["params"])
        updates, opt = tx.update(g["params"], opt, variables["params"])
        new = optax.apply_updates(variables["params"], updates)
        return loss, g, opt, new, cast_floats(upd["batch_stats"], jnp.float32)
    return jax.device_get(step(variables, args, jnp.asarray(b["t"]), jnp.asarray(b["z"])))


def _port_train_step(port, b, precision="f32"):
    """``train_step``'s loss with the draws injected, backward, clip and Adam."""
    state = port_state.create_train_state(port.cfg, port_state.OptimizerConfig(), model=port, device="cpu")
    state.model.train()
    batch = {k: torch.from_numpy(b[k]).long() if b[k].dtype == np.int32 else torch.from_numpy(b[k])
             for k in ("x", "x_lengths", "y", "y_lengths", "spks")}
    dur, prior, diff = port_state._losses(state.model, batch, {"t": torch.from_numpy(b["t"]),
                                                               "z": torch.from_numpy(b["z"])}, None, precision)
    loss = dur + prior + diff
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grads = {n: p.grad.detach().clone().numpy() for n, p in state.model.named_parameters()}
    port_state.apply_gradients(state)
    return float(loss.detach()), grads, state


def _bn_buffers(sd):
    return {k: v for k, v in sd.items() if ".conv.net.5.running_" in k}


def test_train_step_gradients_moments_and_batch_stats_match_jax():
    cfg = with_blocks(tiny_cfg(), ALL, dropout_free=True)
    model, variables, port = matcha_pair(cfg, seed=11)
    b = _train_batch(cfg, 12)
    loss_j, g, opt, new, stats = _jax_train_step(model, variables, b, cfg)
    loss_p, grads, state = _port_train_step(port, b)
    np.testing.assert_allclose(loss_p, float(loss_j), rtol=1e-4)

    theirs = matcha_state_dict_from_flax(g, cfg, buffers=False)
    assert sorted(grads) == sorted(theirs)
    for name, ref in theirs.items():
        bound = 1e-4 * np.abs(ref).max() + 1e-6
        assert np.abs(grads[name] - ref).max() <= bound, (name, np.abs(grads[name] - ref).max(), bound)
    assert all(np.abs(v).max() > 0 for v in theirs.values())  # no dead tensor

    # the moments after one step, 0.1·g and 0.001·g² of the clipped gradient: the gradient's bound carried
    # through (the depthwise convs' biases, which BatchNorm cancels, have gradients of rounding size only)
    adam = opt[1][0]
    mu = matcha_state_dict_from_flax({"params": adam.mu}, cfg, buffers=False)
    nu = matcha_state_dict_from_flax({"params": adam.nu}, cfg, buffers=False)
    for (name, p) in state.model.named_parameters():
        st = state.optimizer.state[p]
        for ours, ref, slack in ((st["exp_avg"].numpy(), mu[name], 1e-7), (st["exp_avg_sq"].numpy(), nu[name], 1e-12)):
            assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max() + slack, name

    ref_stats = _bn_buffers(matcha_state_dict_from_flax({"params": new, "batch_stats": stats}, cfg))
    ours_stats = _bn_buffers(state.model.state_dict())
    assert sorted(ref_stats) == sorted(ours_stats) and len(ref_stats) == 2 * 5  # mean, var of five blocks
    start = _bn_buffers(matcha_state_dict_from_flax(variables, cfg))
    for k, ref in ref_stats.items():
        np.testing.assert_allclose(ours_stats[k].numpy(), ref, rtol=0, atol=1e-6, err_msg=k)
        assert np.abs(ref - start[k]).max() > 1e-4, k  # the statistics moved


def test_eval_step_leaves_batch_stats_alone():
    cfg = with_blocks(tiny_cfg(), ALL)
    _, _, port = matcha_pair(cfg, seed=13)
    b = _train_batch(cfg, 14)
    batch = {k: torch.from_numpy(b[k]).long() if b[k].dtype == np.int32 else torch.from_numpy(b[k])
             for k in ("x", "x_lengths", "y", "y_lengths", "spks")}
    before = _bn_buffers({k: v.clone() for k, v in port.state_dict().items()})
    port.train()
    port_state.eval_step(port, batch)
    assert port.training  # eval_step restores the mode it found
    for k, v in _bn_buffers(port.state_dict()).items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_bf16_mixed_step_keeps_f32_batch_stats_and_follows_jax():
    """Under ``bf16-mixed`` the statistics are updated on the module's own f32
    buffers (not on a cast copy), from bf16 arithmetic, as the JAX step
    updates its bf16-cast ``batch_stats`` and keeps them in f32."""
    cfg = with_blocks(tiny_cfg(), ALL, dropout_free=True)
    model, variables, port = matcha_pair(cfg, seed=15)
    b = _train_batch(cfg, 16)
    loss_j, _, _, _, stats = _jax_train_step(model, variables, b, cfg, "bf16-mixed")
    start = _bn_buffers({k: v.clone() for k, v in port.state_dict().items()})
    loss_p, _, state = _port_train_step(port, b, "bf16-mixed")
    np.testing.assert_allclose(loss_p, float(loss_j), rtol=0.05)
    ref_stats = _bn_buffers(matcha_state_dict_from_flax({"params": variables["params"], "batch_stats": stats}, cfg))
    for k, v in _bn_buffers(state.model.state_dict()).items():
        assert v.dtype == torch.float32, k
        assert float((v - start[k]).abs().max()) > 1e-4, k  # the update landed on the module's buffers
        np.testing.assert_allclose(v.numpy(), ref_stats[k], rtol=1e-2, atol=1e-3, err_msg=k)


def test_conformer_model_exports_and_matches_the_live_call(tmp_path):
    """``torch.export`` of a conformer synthesis program per bucket key:
    BatchNorm in eval mode, the gather's index static at the program's mel
    bucket; the program's mel equals the live model's."""
    from emojivoice_tpu_torch import config as cfglib
    from emojivoice_tpu_torch.inference.export import LoadedBundle, export_bundle
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from tests.test_torch_denoiser_pipeline import tiny_root
    from tests.test_torch_serving import port_root

    root = port_root(tiny_root())
    root = dataclasses.replace(root, model=with_blocks(root.model, ALL))
    assert isinstance(root.model, cfglib.ModelConfig)
    pipe = SynthesisPipeline.from_random(root, seed=0, device="cpu", cleaners=("basic_cleaners",),
                                         text_buckets=(64,), mel_buckets=(128,), with_vocoder=False)
    export_bundle(pipe, str(tmp_path / "b"), batches=(1,), n_timesteps=2, with_vocoder=False)
    bundle = LoadedBundle(str(tmp_path / "b"), device="cpu")
    texts, spks = ["a conformer voice"], [1]
    got, _ = bundle.synthesise(texts, spks=spks, seed=[3], mel_bucket=128)
    want = pipe.synthesise(texts, spks=spks, seed=[3], n_timesteps=2, fused=True, fused_mel_bucket=128,
                           vocode=False)
    assert got[0]["mel_length"] == want[0].mel_length
    np.testing.assert_allclose(np.asarray(got[0]["mel"])[:want[0].mel_length], want[0].mel, atol=1e-5)
