"""K1's bf16 mode, the bf16 vocoder, MAS on a bf16 value and the denoiser's
probe modes, against the JAX package on the CPU.

Tolerances, each with its reason:
* the bf16 MRF twin and the bf16 generator against the Pallas kernel's bf16
  mode (``interpret=True``): atol 2e-4, the bound ``tests/test_pallas_mrf.py``
  holds the f32 kernel to.  Both round the same activations to bf16 and
  multiply exactly in f32, so only the order of the sums differs (and with it,
  rarely, a rounding: see the generator's test);
* the bf16 generator against the f32 one: 0 < max-abs < 2e-2, the JAX
  package's own bound for its bf16 kernel mode (``test_pallas_mrf.py``);
* MAS paths: equal (binary);
* the denoiser's bias spectrum: atol 1e-5, as ``test_denoiser_matches_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu.config import HiFiGANConfig
from emojivoice_tpu.ops.mas import maximum_path as jax_maximum_path
from emojivoice_tpu.ops.pallas_mrf import hifigan_apply_pallas, mrf_stage_pallas, stack_resblock_weights
from emojivoice_tpu.vocoder import Denoiser as JaxDenoiser
from emojivoice_tpu.vocoder import HiFiGANGenerator as FlaxHiFiGAN
from emojivoice_tpu_torch.io.from_jax import hifigan_state_dict_from_flax
from emojivoice_tpu_torch.ops import mas, mrf
from emojivoice_tpu_torch.vocoder.denoiser import Denoiser
from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

torch.set_num_threads(2)

V1_KERNELS = (3, 7, 11)
V1_DILS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
ATOL = 2e-4
BF16 = torch.bfloat16


def _narrow_cfg(initial_channel=32, rates=(4, 2), kernels=(8, 4), rb_kernels=(3, 7, 11), rb_dils=V1_DILS):
    return HiFiGANConfig(upsample_rates=rates, upsample_kernel_sizes=kernels, upsample_initial_channel=initial_channel,
                         resblock_kernel_sizes=rb_kernels, resblock_dilation_sizes=rb_dils, num_mels=12)


def _init_flax(cfg, seed):
    return jax.device_get(FlaxHiFiGAN(cfg=cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, cfg.num_mels))))


def _generator(cfg, params):
    gen = HiFiGANGenerator(cfg)
    gen.load_state_dict({k: torch.tensor(v) for k, v in hifigan_state_dict_from_flax(params, cfg).items()},
                        strict=True)
    return gen


@pytest.mark.parametrize("b,t_len,c,t_tile", [(2, 75, 16, 64), (1, 90, 40, 64)])
def test_bf16_twin_matches_pallas_bf16_mode(rng, b, t_len, c, t_tile):
    """``mrf_stage`` on bf16 weights (a CPU tensor: the plain twin) against
    ``mrf_stage_pallas(compute_dtype=bf16)``; the same stage in f32 differs
    from it by the bf16 rounding, and no kernel launch is counted."""
    cfg = _narrow_cfg(initial_channel=2 * c, rates=(2,), kernels=(4,))
    params = _init_flax(cfg, seed=c)
    # an input of the generator's scale, so that every tap product matters
    x_np = (rng.normal(size=(b, t_len, c)) * 3).astype(np.float32)
    jw = stack_resblock_weights(params, 3, 0, [3, 3, 3])
    pallas = np.asarray(mrf_stage_pallas(jnp.asarray(x_np), jw, V1_KERNELS, V1_DILS, t_tile=t_tile, interpret=True,
                                         compute_dtype=jnp.bfloat16))
    f32 = [tuple(torch.from_numpy(np.asarray(a).copy()) for a in rb) for rb in jw]
    bf16 = [(w1.to(BF16), b1, w2.to(BF16), b2) for w1, b1, w2, b2 in f32]

    before = sum(mrf.launches.values())
    got = mrf.mrf_stage(torch.from_numpy(x_np), bf16, V1_KERNELS, V1_DILS)
    want_f32 = mrf.mrf_stage(torch.from_numpy(x_np), f32, V1_KERNELS, V1_DILS)
    assert sum(mrf.launches.values()) == before
    assert got.dtype == torch.float32 and got.shape == want_f32.shape == (b, t_len, c)
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL)
    assert float((got - want_f32).abs().max()) > 10 * float(np.abs(got.numpy() - pallas).max())  # bf16 really rounds


def test_bf16_twin_rounds_after_the_lrelu():
    """One 1-tap conv on a value whose lrelu lies between two bf16 numbers:
    the twin rounds lrelu(x), not x (rounding x first would land elsewhere)."""
    x = torch.full((1, 1, 1), -1.02)  # bf16(lrelu(x)) = -0.10205, lrelu(bf16(x)) rounds to -0.10254
    w = torch.ones((1, 1, 1, 1), dtype=BF16)
    zero = torch.zeros((1, 1))
    got = mrf.mrf_stage_reference(x, [(w, zero, w, zero)], (1,), ((1,),))
    h = (torch.nn.functional.leaky_relu(x, 0.1)).to(BF16).float()  # conv_d's output
    want = x + torch.nn.functional.leaky_relu(h, 0.1).to(BF16).float()
    assert float(got) == float(want)
    rounded_first = x + torch.nn.functional.leaky_relu(torch.nn.functional.leaky_relu(
        x.to(BF16).float(), 0.1).to(BF16).float(), 0.1).to(BF16).float()
    assert float(got) != float(rounded_first)


def test_bf16_packing_round_trips_and_rounds_to_nearest_even(rng):
    """K1's bf16 operand is w.to(bf16) re-laid [c_out chunk][tap][c_in slice][8-c_in group][c_out][8]:
    unpacked it gives those bits back.  Ties round to even, like JAX's
    astype(bf16) and the kernel's cvt.rn."""
    n_d, k, c = 3, 5, 40  # no multiple of 64: both channel axes zero-padded to one 64-wide chunk
    w = torch.from_numpy(rng.normal(size=(n_d, k, c, c)).astype(np.float32))
    (packed,) = mrf.pack_weights([(w.to(BF16), torch.zeros(n_d, c), w.to(BF16), torch.zeros(n_d, c))])
    assert packed.w1.dtype == BF16 and packed.w1.shape == (n_d, 1, k, 1, 8, 64, 8)
    back = packed.w1.permute(0, 2, 1, 5, 3, 4, 6).reshape(n_d, k, 64, 64)  # (n_d, k, c_out padded, c_in padded)
    assert torch.equal(back[..., :c, :c].transpose(-1, -2), w.to(BF16))
    assert not back[..., c:].float().any() and not back[..., c:, :].float().any()
    ties = torch.tensor([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8), 2 + 2.0 ** -7])
    assert ties.to(BF16).float().tolist() == [1.0, 1 + 2.0 ** -6, -1.0, 2.0]
    np.testing.assert_array_equal(np.asarray(jnp.asarray(ties.numpy()).astype(jnp.bfloat16).astype(jnp.float32)),
                                  ties.to(BF16).float().numpy())


def test_kernel_wrapper_takes_the_mode_from_the_weights(rng):
    """What ``mrf_stage`` checks before it launches K1 (run here on CPU
    tensors): bf16 packed weights select the bf16 mode, f32 the 3xTF32 mode,
    and a stage that mixes them is refused."""
    c = 40
    x = torch.from_numpy(rng.normal(size=(2, 30, c)).astype(np.float32))
    w = [tuple(torch.from_numpy((rng.normal(size=s) * 0.01).astype(np.float32))
               for s in ((3, k, c, c), (3, c), (3, k, c, c), (3, c))) for k in V1_KERNELS]
    w16 = [(w1.to(BF16), b1, w2.to(BF16), b2) for w1, b1, w2, b2 in w]
    assert mrf._check(x, mrf.pack_weights(w16), V1_KERNELS, V1_DILS) is True
    assert mrf._check(x, mrf.pack_weights(w), V1_KERNELS, V1_DILS) is False
    with pytest.raises(ValueError, match="bfloat16"):
        mrf._check(x, mrf.pack_weights(w16[:1]) + mrf.pack_weights(w[1:]), V1_KERNELS, V1_DILS)
    with pytest.raises(ValueError, match="weight shape"):
        mrf._check(x, mrf.pack_weights(w16), (3, 7, 9), V1_DILS)


@pytest.mark.parametrize("batch", [1, 3])
def test_bf16_generator_matches_kernel_based_jax_generator(batch):
    """The port's bf16 vocoder against ``hifigan_apply_pallas(compute_dtype=bf16,
    stages="all")``: only the MRF taps in bf16, the other convs f32.

    The mel is seed 0's.  The two sum in other orders, ~1e-7 apart, and an
    activation that lies that close to a bf16 rounding boundary rounds to the
    other neighbour in one of them: one bf16 step there, which the later
    stages spread over its receptive field (up to ~2e-3 of the waveform, 1 to
    2 such activations in 10^4).  Seed 0 has none at these sizes; a seed that
    has one would be replaced, not tolerated, as the MAS ties of
    ``test_torch_training.py``."""
    cfg = _narrow_cfg()
    params = _init_flax(cfg, seed=6)
    mel = (np.random.default_rng(0).normal(size=(batch, 25, 12)) * 2 - 6).astype(np.float32)
    ref = np.asarray(hifigan_apply_pallas(cfg, params, jnp.asarray(mel), t_tile=64, interpret=True,
                                          compute_dtype=jnp.bfloat16, stages="all"))
    gen = _generator(cfg, params)
    got = gen(torch.from_numpy(mel), compute_dtype=BF16).numpy()
    f32 = gen(torch.from_numpy(mel)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == (batch, 25 * 8)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert 0 < float(np.abs(got - f32).max()) < 2e-2


def test_stage_weights_are_made_once_per_mode(rng):
    cfg = _narrow_cfg()
    gen = _generator(cfg, _init_flax(cfg, seed=1))
    f32, bf16 = gen.stage_weights(0), gen.stage_weights(0, BF16)
    assert gen.stage_weights(0, BF16) is bf16 and gen.stage_weights(0) is f32
    assert all(rb[0].dtype == BF16 and rb[1].dtype == torch.float32 for rb in bf16)
    assert all(torch.equal(a[0].to(BF16), b[0]) for a, b in zip(f32, bf16))
    with torch.no_grad():
        gen.resblocks[0].convs1[0].weight.add_(1.0)
    assert gen.stage_weights(0, BF16) is not bf16
    with pytest.raises(ValueError, match="bf16 mode"):
        gen.stage_weights(0, torch.float16)
    r2 = HiFiGANConfig(resblock="2", upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
                       resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)), num_mels=12)
    with pytest.raises(ValueError, match="ResBlock1"):
        HiFiGANGenerator(r2)(torch.zeros((1, 8, 12)), compute_dtype=BF16)


@pytest.mark.parametrize("case", ["random", "ties"])
def test_mas_on_a_bf16_value_matches_jax(rng, case):
    """``maximum_path`` takes a bf16 log-prior as the JAX package's does: the
    search in f32, the path back in bf16.  The tie-heavy case has values on a
    coarse grid, as a bf16 log-prior of large magnitude has."""
    b, t_x, t_y = 3, 12, 40
    if case == "random":
        value = rng.normal(size=(b, t_x, t_y)) * 30 - 200
    else:
        value = rng.integers(-3, 1, size=(b, t_x, t_y)) * 64.0 - 256.0
    mask = np.zeros((b, t_x, t_y), np.float32)
    for i, (tx, ty) in enumerate([(12, 40), (7, 33), (1, 9)]):
        mask[i, :tx, :ty] = 1
    v16 = torch.from_numpy(value.astype(np.float32)).to(BF16)
    got = mas.maximum_path(v16, torch.from_numpy(mask))
    ref = np.asarray(jax_maximum_path(jnp.asarray(v16.float().numpy()).astype(jnp.bfloat16), jnp.asarray(mask),
                                      backend="jax").astype(jnp.float32))
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert mas.path_faults(got.float(), torch.from_numpy(mask)) == []
    np.testing.assert_array_equal(got.float().numpy(), mas.maximum_path_numpy(v16.float().numpy(), mask))


def test_denoiser_normal_probe_matches_jax(rng):
    """``mode="normal"`` with JAX's own normal draw handed to both probes:
    the same bias spectrum.  The port's default normal draw is its seeded
    generator's (threefry's bits are not reproducible), and unknown modes raise."""
    cfg = _narrow_cfg(rates=(4, 4), kernels=(8, 8), rb_kernels=(3, 5), rb_dils=((1, 3), (1, 3)))
    params = _init_flax(cfg, seed=3)
    gen = _generator(cfg, params)
    jd = JaxDenoiser(lambda m: FlaxHiFiGAN(cfg=cfg).apply(params, m), mode="normal", num_mels=12)
    probe = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 88, 12), jnp.float32)))
    pd = Denoiser(gen, num_mels=12, mode="normal", mel=probe)
    np.testing.assert_allclose(pd.bias_spec.numpy(), np.asarray(jd.bias_spec), atol=1e-5)
    own = Denoiser(gen, num_mels=12, mode="normal")
    assert torch.equal(own.bias_spec, Denoiser(gen, num_mels=12, mode="normal").bias_spec)  # seeded
    assert not torch.equal(own.bias_spec, Denoiser(gen, num_mels=12).bias_spec)
    audio = torch.from_numpy(rng.normal(size=(1, 256 * 12)).astype(np.float32)) * 0.1
    np.testing.assert_allclose(pd(audio, 0.05).numpy(), np.asarray(jd(jnp.asarray(audio.numpy()), 0.05)), atol=1e-5)
    with pytest.raises(ValueError, match="not supported"):
        Denoiser(gen, num_mels=12, mode="uniform")
