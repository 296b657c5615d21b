"""Port's MRF stage and HiFi-GAN generator against the JAX package.

The plain MRF twin (what ``mrf_stage`` runs on a CPU tensor) is held to the
Pallas kernel in interpret mode and to ``mrf_stage_unfused`` at the v1
kernel sizes and narrow widths, with atol 2e-4 — the bound
``tests/test_pallas_mrf.py`` holds the Pallas kernel to.  The K1 CUDA kernel
itself runs only on the card (``tests/test_torch_mrf_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu.config import HiFiGANConfig
from emojivoice_tpu.io.torch_ckpt import convert_hifigan_state_dict
from emojivoice_tpu.ops.pallas_mrf import mrf_stage_pallas, mrf_stage_unfused, stack_resblock_weights
from emojivoice_tpu.vocoder import HiFiGANGenerator as FlaxHiFiGAN
from emojivoice_tpu_torch.io.from_jax import hifigan_state_dict_from_flax
from emojivoice_tpu_torch.ops import mrf
from emojivoice_tpu_torch.vocoder import hifigan
from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

torch.set_num_threads(2)

V1_KERNELS = (3, 7, 11)
V1_DILS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
ATOL = 2e-4


def _narrow_cfg(initial_channel=32, rates=(4, 2), kernels=(8, 4)):
    return HiFiGANConfig(upsample_rates=rates, upsample_kernel_sizes=kernels,
                         upsample_initial_channel=initial_channel, num_mels=12)


def _init_flax(cfg, seed):
    return jax.device_get(FlaxHiFiGAN(cfg=cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, cfg.num_mels))))


def _tensors(sd):
    return {k: torch.tensor(v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def narrow():
    cfg = _narrow_cfg()
    return cfg, _init_flax(cfg, seed=2)


def _torch_weights(jax_weights):
    return [tuple(torch.from_numpy(np.asarray(a).copy()) for a in rb) for rb in jax_weights]


@pytest.mark.parametrize("b,t_len,c,t_tile", [(1, 200, 8, 128), (2, 75, 16, 64)])
def test_mrf_stage_plain_matches_pallas_and_unfused(rng, b, t_len, c, t_tile):
    cfg = _narrow_cfg(initial_channel=2 * c, rates=(2,), kernels=(4,))
    params = _init_flax(cfg, seed=c)
    x_np = rng.normal(size=(b, t_len, c)).astype(np.float32)
    jw = stack_resblock_weights(params, 3, 0, [3, 3, 3])

    pallas = np.asarray(mrf_stage_pallas(jnp.asarray(x_np), jw, V1_KERNELS, V1_DILS, t_tile=t_tile,
                                         interpret=True))
    unfused = np.asarray(mrf_stage_unfused(cfg, params["params"], jnp.asarray(x_np), 0))

    before = sum(mrf.launches.values())
    got = mrf.mrf_stage(torch.from_numpy(x_np), _torch_weights(jw), V1_KERNELS, V1_DILS).numpy()
    assert sum(mrf.launches.values()) == before  # a CPU tensor never reaches the kernel
    assert got.shape == (b, t_len, c)
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, unfused, atol=ATOL)


def test_mrf_stage_rejects_devices_without_a_kernel():
    x = torch.zeros((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        mrf.mrf_stage(x, [], (), ())


@pytest.mark.parametrize("batch", [1, 2])
def test_generator_matches_flax(rng, narrow, batch):
    """The whole v1-kernel generator at a narrow width (initial channel 32)."""
    cfg, params = narrow
    mel = (rng.normal(size=(batch, 25, 12)) * 2 - 6).astype(np.float32)
    ref = np.asarray(FlaxHiFiGAN(cfg=cfg).apply(params, jnp.asarray(mel)))

    gen = HiFiGANGenerator(cfg)
    gen.load_state_dict(_tensors(hifigan_state_dict_from_flax(params, cfg)), strict=True)
    got = gen(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (batch, 25 * 8)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_generator_restacks_mrf_weights_only_after_a_load(rng, narrow):
    """K1's stacked weights are built once, reused across calls, and rebuilt
    when load_state_dict writes the parameters."""
    cfg, params = narrow
    mel = (rng.normal(size=(1, 10, 12)) * 2 - 6).astype(np.float32)
    gen = HiFiGANGenerator(cfg)
    first = gen.stage_weights(0)
    gen(torch.from_numpy(mel))
    assert gen.stage_weights(0) is first
    gen.load_state_dict(_tensors(hifigan_state_dict_from_flax(params, cfg)), strict=True)
    assert gen.stage_weights(0) is not first
    ref = np.asarray(FlaxHiFiGAN(cfg=cfg).apply(params, jnp.asarray(mel)))
    np.testing.assert_allclose(gen(torch.from_numpy(mel)).numpy(), ref, atol=ATOL)


def test_hifigan_bridge_round_trip(narrow):
    """flax → port state dict → the JAX package's own torch→flax converter
    gives back the same tree."""
    cfg, params = narrow
    sd = hifigan_state_dict_from_flax(params, cfg)
    back = convert_hifigan_state_dict(sd, cfg)["params"]
    flat_a = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))
    missing, unexpected = HiFiGANGenerator(cfg).load_state_dict(_tensors(sd), strict=False)
    assert missing == [] and unexpected == []


def test_resblock2_generator_serves_on_plain_convs(rng, monkeypatch):
    """HiFi-GAN v2/v3's ResBlock2 has no fused stage in the JAX package
    (``stack_resblock_weights`` reads ResBlock1's convs only), so the port's
    serving forward runs it on plain convs: no ``mrf_stage`` call, and the
    flax module's waveform within atol 1e-5."""
    cfg = HiFiGANConfig(resblock="2", upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
                        resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)), num_mels=12)
    params = _init_flax(cfg, seed=5)
    mel = (rng.normal(size=(2, 25, 12)) * 2 - 6).astype(np.float32)
    ref = np.asarray(FlaxHiFiGAN(cfg=cfg).apply(params, jnp.asarray(mel)))
    gen = HiFiGANGenerator(cfg)
    sd = hifigan_state_dict_from_flax(params, cfg)
    assert "resblocks.3.convs.1.weight" in sd and not any(".convs1." in k for k in sd)
    gen.load_state_dict(_tensors(sd), strict=True)
    calls = []
    monkeypatch.setattr(hifigan, "mrf_stage", lambda *a, **kw: calls.append(a) or mrf.mrf_stage(*a, **kw))
    got = gen(torch.from_numpy(mel))
    assert not calls and not got.requires_grad and got.shape == (2, 25 * 8)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    with pytest.raises(RuntimeError, match="ResBlock1"):
        gen.stage_weights(0)
    # the same spy does see a ResBlock1 generator's stages
    HiFiGANGenerator(_narrow_cfg())(torch.from_numpy(mel))
    assert len(calls) == 2
