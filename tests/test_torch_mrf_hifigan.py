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
from emojivoice_tpu_torch import config as torch_config
from emojivoice_tpu_torch.io.from_jax import hifigan_state_dict_from_flax
from emojivoice_tpu_torch.ops import mrf
from emojivoice_tpu_torch.vocoder import hifigan
from emojivoice_tpu_torch.vocoder.denoiser import Denoiser, read_past
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


def test_registered_op_passes_opcheck(rng):
    """``emojivoice_tpu_torch::mrf_stage``: schema, fake implementation (the
    shape ``torch.export`` traces with) and its CPU implementation, the plain
    twin, through ``torch.library.opcheck``; ``mrf_stage`` goes through it."""
    c, t_len = 8, 20
    w = [tuple(torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32))
               for s in ((3, k, c, c), (3, c), (3, k, c, c), (3, c))) for k in (3, 5)]
    x = torch.from_numpy(rng.normal(size=(2, t_len, c)).astype(np.float32))
    args = (x, [p for rb in w for p in rb], [3, 5], [1, 3, 5, 1, 2, 3], [3, 3])
    op = torch.ops.emojivoice_tpu_torch.mrf_stage.default
    torch.library.opcheck(op, args)
    want = mrf.mrf_stage_reference(x, w, (3, 5), ((1, 3, 5), (1, 2, 3)))
    torch.testing.assert_close(op(*args), want, rtol=0, atol=0)
    torch.testing.assert_close(mrf.mrf_stage(x, w, (3, 5), ((1, 3, 5), (1, 2, 3))), want, rtol=0, atol=0)


def test_exported_generator_keeps_the_op_as_one_node_per_stage(rng, narrow, tmp_path):
    """A generator exported on the CPU (``for_export``), saved and reloaded:
    one ``mrf_stage`` node per stage, no res-block parameter carried, and the
    live forward's waveform to the bit."""
    cfg, params = narrow
    gen = HiFiGANGenerator(cfg)
    gen.load_state_dict(_tensors(hifigan_state_dict_from_flax(params, cfg)), strict=True)
    mel = torch.from_numpy((rng.normal(size=(2, 25, 12)) * 2 - 6).astype(np.float32))
    with torch.no_grad():
        exported = torch.export.export(gen.for_export().eval(), (mel,))
    nodes = [n for n in exported.graph.nodes if "emojivoice_tpu_torch.mrf_stage" in str(n.target)]
    assert len(nodes) == len(cfg.upsample_rates) == 2
    assert not any(".convs1." in k or ".convs2." in k for k in exported.state_dict)
    torch.export.save(exported, tmp_path / "voc.pt2")
    before = sum(mrf.launches.values())
    with torch.inference_mode():
        got = torch.export.load(tmp_path / "voc.pt2").module()(mel)
    assert sum(mrf.launches.values()) == before
    torch.testing.assert_close(got, gen(mel), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(FlaxHiFiGAN(cfg=cfg).apply(params, jnp.asarray(mel.numpy()))),
                               atol=ATOL)


BUCKET = 256  # mel frames of the padded call


@pytest.mark.parametrize("served", [
    (BUCKET, BUCKET - 1, BUCKET - 200, 0, 0),  # a row at the full bucket, rows 1 and 200 frames short, two pad rows
    (BUCKET - 1,),  # B = 1
    None,  # no reach
], ids=["padded_batch", "b1", "no_reach"])
def test_reach_keeps_every_served_sample(rng, served):
    """HiFi-GAN v1's strides, up-sampling kernels and res-blocks (at a narrow
    width) and the denoiser over a padded batch.  With each row's served
    frames the MRF stages compute only their reach (``stage_reach``; the
    plain twin writes NaN past it after every conv, where K1 leaves the frames
    unwritten), and every served sample [0, L·256) of a live row equals the
    call without a reach to the bit, which holds the margins worked back from
    the denoiser's window, ``conv_post``, the up-sampling convs and the
    res-blocks' halos; a pad row is NaN whole, nothing of it computed.
    Without a reach every frame is computed, as the plain convs compute it."""
    cfg = torch_config.HiFiGANConfig(upsample_initial_channel=32, num_mels=12)
    assert cfg.total_upsample == 256 and tuple(cfg.resblock_kernel_sizes) == V1_KERNELS
    torch.manual_seed(3)
    gen = HiFiGANGenerator(cfg).eval()
    denoiser = Denoiser(gen, num_mels=cfg.num_mels)
    b = 1 if served is None else len(served)
    mel = torch.from_numpy((rng.normal(size=(b, BUCKET, cfg.num_mels)) * 2 - 6).astype(np.float32))
    every = gen(mel)
    if served is None:
        with torch.no_grad():
            assert torch.equal(every, gen.forward_train(mel))
        return
    tail = read_past(cfg.total_upsample)
    margin = max(gen.reach_margins(tail))
    assert tail == 768 and 10 <= margin <= 15
    reached = gen(mel, served=torch.tensor(served, dtype=torch.int32), tail=tail)
    want, got = denoiser(every, 0.05), denoiser(reached, 0.05)
    for row, n in enumerate(served):
        if n == 0:
            assert bool(torch.isnan(reached[row]).all())
            continue
        assert torch.equal(got[row, :n * 256], want[row, :n * 256])
        if n + margin < BUCKET:  # the reach left the rest of the row
            assert bool(torch.isnan(reached[row, (n + margin) * 256:]).all())
