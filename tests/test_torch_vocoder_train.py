"""The port's vocoder-training path against the JAX package on the CPU: the
generator in weight-norm mode and with ResBlock2, the fold, and the
alternating GAN step.

Generators are narrow (initial channel 32) with ×256 upsampling, so a mel
frame is one hop of the loss mel; the discriminators run at their published
widths on batch 2 × 2,048 samples.  Weights and both Adam states are carried
across by ``io/from_jax.py``; mels and waveforms come from a numpy seed.

Tolerances, each with its reason:
* generator outputs, and folded against unfolded: atol 1e-5 (f32 convs in
  another summation order; the waveform is in [-1, 1]);
* the step's five metrics: rtol 1e-4;
* gradients: per tensor, max-abs difference ≤ 1e-4 · that tensor's max-abs
  gradient + 1e-6, as ``tests/test_torch_training.py`` holds the acoustic
  model's;
* parameters after two steps: atol 4e-4.  Adam's first steps move every
  element by about lr = 2e-4 whatever its gradient's size, so an element whose
  tiny gradient rounds differently can differ by up to lr per step; the mean
  difference over all elements is held to 2e-6 beside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu import config as jax_cfglib
from emojivoice_tpu.io.torch_ckpt import fold_hifigan_weight_norm
from emojivoice_tpu.training import vocoder_train as jvt
from emojivoice_tpu.vocoder import HiFiGANGenerator as FlaxHiFiGAN
from emojivoice_tpu.vocoder import discriminators as jvt_disc
from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.io.from_jax import (
    hifigan_state_dict_from_flax,
    load_vocoder_adam_states_from_optax,
    mpd_state_dict_from_flax,
    msd_state_dict_from_flax,
)
from emojivoice_tpu_torch.training import vocoder_train as tvt
from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

torch.set_num_threads(2)

B, SEG = 2, 8
NARROW = dict(upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=32, num_mels=80)
BLOCKS = {"1": dict(resblock="1", resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3))),
          "2": dict(resblock="2", resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)))}


def _cfgs(resblock):
    kw = dict(NARROW, **BLOCKS[resblock])
    return jax_cfglib.HiFiGANConfig(**kw), cfglib.HiFiGANConfig(**kw)


def _tensors(sd):
    return {k: torch.tensor(v) for k, v in sd.items()}


def _perturbed(params, seed):
    """flax starts biases at 0 and weight-norm magnitudes at 1: move both."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        scale = {"bias": 0.05, "g": 0.3}.get(name, 0.0)
        return np.asarray(a + scale * rng.normal(size=a.shape), np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


def _flax_generator(jcfg, weight_norm, seed):
    mod = FlaxHiFiGAN(cfg=jcfg, weight_norm=weight_norm)
    return mod, _perturbed(jax.device_get(mod.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, jcfg.num_mels)))), seed)


def _mel(seed, frames=11):
    return (np.random.default_rng(seed).normal(size=(B, frames, 80)) * 2 - 6).astype(np.float32)


@pytest.mark.parametrize("resblock,weight_norm", [("1", True), ("2", True), ("2", False)])
def test_generator_matches_flax(resblock, weight_norm):
    jcfg, cfg = _cfgs(resblock)
    mod, params = _flax_generator(jcfg, weight_norm, seed=3)
    mel = _mel(0)
    ref = np.asarray(mod.apply(params, jnp.asarray(mel)))
    gen = HiFiGANGenerator(cfg, weight_norm=weight_norm)
    gen.load_state_dict(_tensors(hifigan_state_dict_from_flax(params, cfg)), strict=True)
    got = gen.forward_train(torch.from_numpy(mel))
    assert got.requires_grad and got.shape == ref.shape == (B, 11 * 256)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5)
    if not weight_norm:  # the serving forward of a ResBlock2 generator is the same plain function
        np.testing.assert_array_equal(gen(torch.from_numpy(mel)).numpy(), got.detach().numpy())
    names = sorted(gen.state_dict())
    assert ("ups.0.weight_g" in names) == weight_norm and ("resblocks.0.convs.0.bias" in names) == (resblock == "2")
    if weight_norm:  # one magnitude per output channel of a conv, per input channel of a transposed conv
        sd = gen.state_dict()
        assert sd["conv_pre.weight_g"].shape == (32, 1, 1) and sd["ups.0.weight_g"].shape == (32, 1, 1)
        assert sd["ups.1.weight_v"].shape == (16, 8, 16) and sd["ups.1.weight_g"].shape == (16, 1, 1)


def test_folded_equals_unfolded_and_the_jax_fold():
    jcfg, cfg = _cfgs("1")
    mod, params = _flax_generator(jcfg, True, seed=4)
    mel = torch.from_numpy(_mel(1))
    gen = HiFiGANGenerator(cfg, weight_norm=True)
    gen.load_state_dict(_tensors(hifigan_state_dict_from_flax(params, cfg)), strict=True)
    unfolded = gen.forward_train(mel).detach().numpy()
    plain = gen.fold_weight_norm()
    assert not plain.weight_norm and not plain.training and "conv_pre.weight" in plain.state_dict()
    np.testing.assert_allclose(plain(mel).numpy(), unfolded, atol=1e-5)  # through mrf_stage's plain twin
    np.testing.assert_allclose(plain.forward_train(mel).detach().numpy(), unfolded, atol=1e-5)
    theirs = hifigan_state_dict_from_flax(fold_hifigan_weight_norm(params), cfg)
    ours = plain.state_dict()
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k].numpy(), v, atol=1e-6, err_msg=k)
    # the fused path never sees a weight-norm generator, whose folded weights would go stale as it trains
    with pytest.raises(RuntimeError, match="fold_weight_norm"):
        gen(mel)
    with pytest.raises(RuntimeError, match="fold_weight_norm"):
        gen.stage_weights(0)
    # training the weight-norm generator moves what a later fold gives
    gen.forward_train(mel).square().mean().backward()
    with torch.no_grad():
        gen.conv_post.weight_g -= 0.1
    assert not torch.equal(gen.fold_weight_norm().conv_post.weight, plain.conv_post.weight)


def test_weight_norm_init_is_the_plain_init():
    """Like ``torch.nn.utils.weight_norm``: v the conv's init, g its norm, so
    the weight at step 0 is the plain init."""
    _, cfg = _cfgs("1")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        plain = HiFiGANGenerator(cfg)
        torch.manual_seed(0)
        wn = HiFiGANGenerator(cfg, weight_norm=True)
    for name in ("conv_pre", "conv_post"):
        np.testing.assert_allclose(getattr(wn, name).weight.detach().numpy(),
                                   getattr(plain, name).weight.detach().numpy(), atol=1e-7)
    np.testing.assert_allclose(wn.ups[1].weight.detach().numpy(), plain.ups[1].weight.detach().numpy(), atol=1e-7)


# ---------------------------------------------------------------------------
# the alternating GAN step
# ---------------------------------------------------------------------------

def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"mel": (rng.normal(size=(B, SEG, 80)) * 2 - 6).astype(np.float32),
            "wav": (0.3 * rng.normal(size=(B, SEG * 256))).astype(np.float32)}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps from a seeded init; the port starts from the state
    after the first (a non-zero Adam state on both sides)."""
    jcfg, cfg = _cfgs("1")
    state, modules = jvt.create_vocoder_state(jcfg, seed=0, segment_frames=SEG, weight_norm=True)
    state = state.replace(gen_params=_perturbed(jax.device_get(state.gen_params), 5))
    step = jax.jit(jvt.make_vocoder_train_step(jcfg, modules).__wrapped__)  # the same step, nothing donated
    states, metrics = [], []
    for i in range(3):
        state, m = step(state, _jbatch(_batch(20 + i)))
        states.append(jax.device_get(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return jcfg, cfg, modules, states, metrics


def _port_state(cfg, jstate):
    state = tvt.create_vocoder_state(
        cfg, seed=0, device="cpu", gen_state=_tensors(hifigan_state_dict_from_flax(jstate.gen_params, cfg)),
        disc_state={"mpd": _tensors(mpd_state_dict_from_flax(jstate.disc_params["mpd"])),
                    "msd": _tensors(msd_state_dict_from_flax(jstate.disc_params["msd"]))})
    g, d = jstate.gen_opt[0], jstate.disc_opt[0]  # optax.adam: (ScaleByAdamState, EmptyState)
    load_vocoder_adam_states_from_optax(state, g.mu, g.nu, int(g.count), d.mu, d.nu, int(d.count))
    state.step = int(jstate.step)
    return state


def _jax_gradients(jcfg, modules, before, after, batch):
    """The step's two gradients, recomputed with the JAX modules: the
    discriminators' at the state before the step, the generator's against the
    discriminators after it.

    One exception: in f32 XLA's CPU backend gives the first three convs of
    the third scale discriminator a gradient 1 to 5 % off its own float64
    result (the input gradient of the 41-tap stride-4 grouped conv on the real
    waveform), while PyTorch's f32 gradient is within 1e-6 of that float64
    result.  Those three convs are therefore held against the JAX module's
    float64 gradient, with the same bound."""
    gen, mpd, msd, _, _ = modules
    mel, wav = jnp.asarray(batch["mel"]), jnp.asarray(batch["wav"])
    y_hat = gen.apply(before.gen_params, mel)

    def d_loss_fn(dp):
        r_p, g_p, _, _ = mpd.apply(dp["mpd"], wav, y_hat)
        r_s, g_s, _, _ = msd.apply(dp["msd"], wav, y_hat)
        return jvt.discriminator_loss(r_p, g_p)[0] + jvt.discriminator_loss(r_s, g_s)[0]

    fmax = jcfg.sampling_rate / 2.0
    target = jvt.mel_spectrogram(wav, 1024, jcfg.num_mels, jcfg.sampling_rate, 256, 1024, 0.0, fmax)

    def g_loss_fn(gp):
        y_g = gen.apply(gp, mel)
        mel_g = jvt.mel_spectrogram(y_g, 1024, jcfg.num_mels, jcfg.sampling_rate, 256, 1024, 0.0, fmax)
        _, g_p, f_rp, f_gp = mpd.apply(after.disc_params["mpd"], wav, y_g)
        _, g_s, f_rs, f_gs = msd.apply(after.disc_params["msd"], wav, y_g)
        return (jnp.mean(jnp.abs(mel_g - target)) * jvt.MEL_LOSS_WEIGHT
                + (jvt.feature_loss(f_rp, f_gp) + jvt.feature_loss(f_rs, f_gs)) * jvt.FM_LOSS_WEIGHT / 2.0
                + jvt.generator_loss(g_p)[0] + jvt.generator_loss(g_s)[0])

    d_grads, g_grads = jax.device_get((jax.jit(jax.grad(d_loss_fn))(before.disc_params),
                                       jax.jit(jax.grad(g_loss_fn))(before.gen_params)))

    # the third scale discriminator alone, in float64, on the twice-pooled waveforms
    def pooled(w):
        for _ in range(2):
            w = jvt_disc.nn.avg_pool(w[..., None], (4,), strides=(2,), padding=((2, 2),))[..., 0]
        return w

    with jax.enable_x64(True):
        third = jvt_disc.DiscriminatorS()
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                           {"params": before.disc_params["msd"]["params"]["discriminators_2"]})
        real, fake = (pooled(jnp.asarray(np.asarray(w), jnp.float64)) for w in (wav, y_hat))
        exact = jax.grad(lambda p: jvt.discriminator_loss([third.apply(p, real)[0]], [third.apply(p, fake)[0]])[0])(p64)
        exact = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.device_get(exact))
    for j in range(3):
        d_grads["msd"]["params"]["discriminators_2"][f"convs_{j}"] = exact["params"][f"convs_{j}"]
    return d_grads, g_grads


def test_gan_step_matches_jax(jax_run):
    jcfg, cfg, modules, states, metrics = jax_run
    state = _port_state(cfg, states[0])
    assert state.step == 1 and state.gen.weight_norm and state.gen.training
    frozen_before = [p.detach().clone() for p in state.disc_parameters()]

    # one step from the same state and batch: metrics and both gradients
    ours = tvt.vocoder_train_step(state, _tbatch(_batch(21)))
    assert sorted(ours) == ["adv_loss", "d_loss", "fm_loss", "g_loss", "mel_l1"]
    for k, v in ours.items():
        np.testing.assert_allclose(float(v), metrics[1][k], rtol=1e-4, err_msg=k)
    assert all(p.requires_grad for p in state.disc_parameters())  # unfrozen again after the generator's pass
    assert any(not torch.equal(a, b) for a, b in zip(frozen_before, state.disc_parameters()))

    d_grads, g_grads = _jax_gradients(jcfg, modules, states[0], states[1], _batch(21))
    theirs = {**{f"gen.{k}": v for k, v in hifigan_state_dict_from_flax(g_grads, cfg).items()},
              **{f"mpd.{k}": v for k, v in mpd_state_dict_from_flax(d_grads["mpd"]).items()},
              **{f"msd.{k}": v for k, v in msd_state_dict_from_flax(d_grads["msd"]).items()}}
    # the discriminators' .grad is still the one of their own update: the generator's pass gave them none
    named = {f"{prefix}.{n}": p for prefix, m in (("gen", state.gen), ("mpd", state.mpd), ("msd", state.msd))
             for n, p in m.named_parameters()}
    assert sorted(named) == sorted(theirs)
    for name, p in named.items():
        g, ref = p.grad.numpy(), theirs[name]
        bound = 1e-4 * np.abs(ref).max() + 1e-6
        assert np.abs(g - ref).max() <= bound, f"{name}: {np.abs(g - ref).max()} over {bound}"
    assert all(float(np.abs(v).max()) > 0 for v in theirs.values())  # no dead tensor

    # a second step, then the parameters
    ours = tvt.vocoder_train_step(state, _tbatch(_batch(22)))
    for k, v in ours.items():
        np.testing.assert_allclose(float(v), metrics[2][k], rtol=1e-4, err_msg=k)
    assert state.step == 3 == int(states[2].step)
    final = {**{f"gen.{k}": v for k, v in hifigan_state_dict_from_flax(states[2].gen_params, cfg).items()},
             **{f"mpd.{k}": v for k, v in mpd_state_dict_from_flax(states[2].disc_params["mpd"]).items()},
             **{f"msd.{k}": v for k, v in msd_state_dict_from_flax(states[2].disc_params["msd"]).items()}}
    start = {**{f"gen.{k}": v for k, v in hifigan_state_dict_from_flax(states[0].gen_params, cfg).items()}}
    total, count, moved = 0.0, 0, 0.0
    for name, p in named.items():
        diff = np.abs(p.detach().numpy() - final[name])
        assert diff.max() <= 4e-4, f"{name}: {diff.max()}"
        total, count = total + float(diff.sum()), count + diff.size
        if name in start:
            moved = max(moved, float(np.abs(final[name] - start[name]).max()))
    assert total / count < 2e-6 and moved > 1e-4  # close everywhere, and the steps did move the generator


def test_no_gradient_reaches_the_discriminators_in_the_generator_pass():
    _, cfg = _cfgs("1")
    state = tvt.create_vocoder_state(cfg, seed=1, device="cpu")
    b = _tbatch(_batch(30))
    y_hat = state.gen.forward_train(b["mel"])
    for p in state.disc_parameters():
        p.requires_grad_(False)
    total, loss_mel, loss_fm, loss_adv = tvt.generator_losses(state, b["wav"], y_hat)
    total.backward()
    assert all(p.grad is None for p in state.disc_parameters())
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in state.gen.parameters())
    np.testing.assert_allclose(float(total.detach()), float((loss_mel + loss_fm + loss_adv).detach()), rtol=1e-6)
    # the loss mel is full band: its top filters look above the conditioning mels' 8 kHz
    full = tvt.loss_mel_spectrogram(b["wav"], cfg)
    narrow = tvt.mel_spectrogram(b["wav"], 1024, 80, 22050, 256, 1024, 0.0, 8000.0)
    assert full.shape == narrow.shape == (B, SEG, 80) and not torch.allclose(full, narrow)


def test_create_vocoder_state_defaults_to_the_card():
    _, cfg = _cfgs("1")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tvt.create_vocoder_state(cfg)
    a = tvt.create_vocoder_state(cfg, seed=3, device="cpu", weight_norm=False)
    b = tvt.create_vocoder_state(cfg, seed=3, device="cpu", weight_norm=False)
    assert not a.gen.weight_norm and a.step == 0
    assert all(torch.equal(p, q) for p, q in zip(a.gen.parameters(), b.gen.parameters()))
    assert all(torch.equal(p, q) for p, q in zip(a.disc_parameters(), b.disc_parameters()))
    assert a.gen_opt.defaults["betas"] == (0.8, 0.99) and a.disc_opt.defaults["lr"] == 2e-4
