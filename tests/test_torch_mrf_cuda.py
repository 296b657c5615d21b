"""K1, the MRF res-block CUDA kernel, against its plain twin on the card.

Needs an NVIDIA GPU and nvcc; skipped elsewhere.  Imports no JAX, so it runs
where the port runs:

    python -m pytest --noconftest -m cuda tests/test_torch_mrf_cuda.py -q

Tolerance: atol = rtol = 2e-4 with TF32 off, the bound
``tests/test_pallas_mrf.py`` holds the Pallas kernel to.
"""

import pytest
import torch

from emojivoice_tpu_torch.ops import mrf

KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
TOL = 2e-4


@pytest.fixture
def cuda_f32():
    if not torch.cuda.is_available():
        pytest.skip("K1 is a CUDA kernel: it needs an NVIDIA GPU and nvcc")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _stage(b, c, t, seed, kernels=KERNELS):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, t, c), generator=g)
    weights = [tuple(torch.randn(shape, generator=g) * 0.01
                     for shape in ((3, k, c, c), (3, c), (3, k, c, c), (3, c)))
               for k in kernels]
    return x.cuda(), [tuple(w.cuda() for w in rb) for rb in weights]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t_len", [(1, 256, 512), (1, 32, 4096), (2, 64, 1000), (3, 40, 77),
                                       (3, 20, 50), (3, 20, 333), (1, 128, 63), (3, 6, 40)])
def test_k1_matches_plain_twin(cuda_f32, b, c, t_len):
    x, w = _stage(b, c, t_len, seed=c)
    before = mrf.launches[c]
    got = mrf.mrf_stage(x, w, KERNELS, DILATIONS)
    torch.cuda.synchronize()
    assert mrf.launches[c] == before + 1
    torch.testing.assert_close(got, mrf.mrf_stage_reference(x, w, KERNELS, DILATIONS), atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t_len", [(1, 128, 700), (3, 20, 50)])
def test_k1_packed_and_contract_weights_give_the_same_bits(cuda_f32, b, c, t_len):
    x, w = _stage(b, c, t_len, seed=c + 1)
    packed = mrf.pack_weights(w)
    assert all(isinstance(rb, mrf.PackedResblock) and rb.w1.is_cuda for rb in packed)
    assert torch.equal(mrf.mrf_stage(x, packed, KERNELS, DILATIONS), mrf.mrf_stage(x, w, KERNELS, DILATIONS))


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,d", [(64, 1, 1), (256, 1, 1), (32, 3, 2), (40, 11, 5)])
def test_k1_tensor_core_product_against_float64(cuda_f32, c, k, d):
    """One convolution of K1 (the three-product TF32 sum) against float64:
    the error of an f32 sum, far below one TF32 product's ~1e-3 relative."""
    g = torch.Generator().manual_seed(c + k)
    x = (torch.rand((1, 64, c), generator=g) + 0.1).cuda()  # positive: the lrelu is the identity
    w = (torch.randn((k, c, c), generator=g) * 0.1).cuda()
    bias = torch.randn((c,), generator=g).cuda()
    got = mrf.conv_taps(x, w, bias, d)
    ref = torch.nn.functional.conv1d(x.double().transpose(1, 2), w.double().permute(2, 1, 0), bias.double(),
                                     padding=(k // 2) * d, dilation=d).transpose(1, 2)
    assert float((got.double() - ref).abs().max()) < 2e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_k1_rejects_what_it_cannot_run(cuda_f32):
    x, w = _stage(1, 32, 64, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        mrf.mrf_stage(x.transpose(1, 2).contiguous().transpose(1, 2), w, KERNELS, DILATIONS)
    with pytest.raises(ValueError, match="float32"):
        mrf.mrf_stage(x.double(), w, KERNELS, DILATIONS)
    with pytest.raises(ValueError, match="weight shape"):
        mrf.mrf_stage(x, w, (3, 7, 9), DILATIONS)
    x_even, w_even = _stage(1, 32, 64, seed=1, kernels=(4, 7, 11))
    with pytest.raises(ValueError, match="odd"):
        mrf.mrf_stage(x_even, w_even, (4, 7, 11), DILATIONS)


@pytest.mark.cuda
def test_k1_runs_inside_an_exported_vocoder(cuda_f32, tmp_path, monkeypatch):
    """An exported, saved and reloaded v1 vocoder on the card launches K1
    once per stage through the registered op, gives the live forward's
    waveform to the bit, and raises when the kernel cannot be built: no
    fallback to the plain twin inside the program either."""
    from emojivoice_tpu_torch.config import HiFiGANConfig
    from emojivoice_tpu_torch.kernels import build
    from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

    torch.manual_seed(0)
    gen = HiFiGANGenerator(HiFiGANConfig()).cuda().eval()
    mel = torch.randn((1, 64, 80), device="cuda") * 2 - 6
    with torch.no_grad():
        exported = torch.export.export(gen.for_export().eval(), (mel,))
    torch.export.save(exported, tmp_path / "voc.pt2")
    program = torch.export.load(tmp_path / "voc.pt2").module()
    before = sum(mrf.launches.values())
    with torch.inference_mode():
        got = program(mel)
    torch.cuda.synchronize()
    assert sum(mrf.launches.values()) == before + 4
    assert torch.equal(got, gen(mel))

    def no_build():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(build, "load_mrf", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"), torch.inference_mode():
        program(mel)
