"""K1, the MRF res-block CUDA kernel, against its plain twin on the card.

Needs an NVIDIA GPU and nvcc; skipped elsewhere.  Imports no JAX, so it runs
where the port runs:

    python -m pytest --noconftest -m cuda tests/test_torch_mrf_cuda.py -q

Tolerance: atol = rtol = 2e-4 with TF32 off, the bound
``tests/test_pallas_mrf.py`` holds the Pallas kernel to.  In bf16 mode the
twin's bf16 branch rounds the same activations, but kernel and twin sum in
other orders, and an intermediate whose f32 value lies that close to a bf16
rounding boundary is rounded to neighbouring bf16 numbers: one bf16 step
(2⁻⁸ relative) of that activation, which moves each of the k·C outputs that
read it by |w|·step.  At C = 256 that reached 4.8e-4 in 0.3 % of the outputs
on the H100.  So a bf16 stage is held within 2e-4 on at least 99 % of its
outputs and within 2e-3 (BF16_FLIP_TOL, a tenth of the 2e-2 of bf16 against
f32) on all.  The tensor cores' f32 sums truncate toward zero, so the kernel
sums each tap's chain from zero and adds the taps in f32 (its one-conv mean
error against float64 is held under 3× cuDNN f32's on the same operands);
over the nine units of a stage flips still cascade: there its median error
is held under 0.35 of the median gap between the twin on bf16 and on f32
weights.  On one dilation unit, where flips stay sparse,
it is held under a tenth of that gap (0.009 measured at C = 256).  A kernel
that never rounded the activation sits ~0.7 of the gap away in both.  One
convolution, which has no intermediate, on signed x that is not bf16-exact, is
held to float64 of the operands rounded where ``_conv_same`` rounds them at
1e-5 relative, and float64 rounding before the lrelu or not at all must miss
that bound.
"""

import pytest
import torch

from emojivoice_tpu_torch.ops import mrf

KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
TOL = 2e-4
BF16_FLIP_TOL, BF16_GAP_SHARE, BF16_STAGE_SHARE, BF16_TILE_TOL = 2e-3, 0.1, 0.35, 1e-5


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
    before = mrf.launches[(c, "f32")]
    got = mrf.mrf_stage(x, w, KERNELS, DILATIONS)
    torch.cuda.synchronize()
    assert mrf.launches[(c, "f32")] == before + 1
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


def _bf16(w):
    return [(w1.to(torch.bfloat16), b1, w2.to(torch.bfloat16), b2) for w1, b1, w2, b2 in w]


def _median(v):
    return float(v.flatten().median())


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t_len", [(1, 256, 4096), (1, 128, 32768), (1, 64, 65536), (1, 32, 131072),
                                       (8, 128, 32768), (8, 256, 4096), (32, 256, 4096), (8, 64, 65536),
                                       (8, 32, 131072), (3, 40, 77), (3, 20, 50), (3, 6, 40),
                                       (1, 256, 640), (1, 128, 5120), (1, 64, 10240), (1, 32, 20480),
                                       (3, 40, 333), (3, 20, 1001)])
def test_k1_bf16_matches_plain_twin(cuda_f32, b, c, t_len):
    """K1's bf16 mode (``mrf_resblock_bf16``) at the four HiFi-GAN v1 stage
    shapes of a 512-frame utterance, at batch 8 and at batch 32 with C = 256
    (every route and block shape the launcher's rules pick on the serving
    path: one-conv blocks of one or several N chunks, fused units), ragged,
    and at the four stage shapes of one 80-frame streaming window."""
    x, w = _stage(b, c, t_len, seed=c + 7)
    w16 = _bf16(w)
    before = mrf.launches[(c, "bf16")]
    got = mrf.mrf_stage(x, w16, KERNELS, DILATIONS)
    torch.cuda.synchronize()
    assert mrf.launches[(c, "bf16")] == before + 1
    ref = mrf.mrf_stage_reference(x, w16, KERNELS, DILATIONS)
    err = (got - ref).abs()
    assert float((err <= TOL + TOL * ref.abs()).float().mean()) >= 0.99
    assert float(err.max()) <= BF16_FLIP_TOL
    assert torch.equal(got, mrf.mrf_stage(x, mrf.pack_weights(w16), KERNELS, DILATIONS))
    assert float((got - mrf.mrf_stage(x, w, KERNELS, DILATIONS)).abs().max()) > TOL / 100  # not the f32 mode
    gap = (ref - mrf.mrf_stage_reference(x, w, KERNELS, DILATIONS)).abs()  # what bf16 moves the stage by
    assert _median(err) <= BF16_STAGE_SHARE * _median(gap)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t_len", [(1, 256, 4096), (1, 128, 32768), (1, 64, 65536), (1, 32, 131072)])
def test_k1_bf16_rounds_the_intermediate_after_its_lrelu(cuda_f32, b, c, t_len):
    """One dilation unit (k = 11, d = 1): the intermediate is rounded after
    its lrelu, as the twin rounds it; unrounded activations would miss."""
    x, w = _stage(b, c, t_len, seed=c + 9, kernels=(11,))
    w = [tuple(t[:1].contiguous() for t in w[0])]
    w16 = _bf16(w)
    got = mrf.mrf_stage(x, w16, (11,), ((1,),))
    ref = mrf.mrf_stage_reference(x, w16, (11,), ((1,),))
    gap = (ref - mrf.mrf_stage_reference(x, w, (11,), ((1,),))).abs()
    unrounded = mrf.mrf_stage_reference(x, [(w1.float(), b1, w2.float(), b2) for w1, b1, w2, b2 in w16],
                                        (11,), ((1,),))
    assert _median((got - ref).abs()) <= BF16_GAP_SHARE * _median(gap) < _median((unrounded - ref).abs())


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,d", [(64, 1, 1), (256, 1, 1), (32, 3, 2), (40, 11, 5)])
def test_k1_bf16_product_against_float64(cuda_f32, c, k, d):
    """One convolution in bf16 mode against float64 on the same operands:
    the activation rounded after the lrelu, one exact product per tap, summed
    in f32.  x is signed and not bf16-exact, so rounding before the lrelu or
    not at all would miss the bound."""
    g = torch.Generator().manual_seed(c + k)
    x = torch.randn((1, 64, c), generator=g).cuda()
    w = (torch.randn((k, c, c), generator=g) * 0.1).to(torch.bfloat16).cuda()
    bias = (torch.randn((c,), generator=g) * 0.1).cuda()
    got = mrf.conv_taps(x, w, bias, d).double()

    def conv(a):
        return torch.nn.functional.conv1d(a.double().transpose(1, 2), w.double().permute(2, 1, 0), bias.double(),
                                          padding=(k // 2) * d, dilation=d).transpose(1, 2)

    def lrelu(a):
        return torch.nn.functional.leaky_relu(a, mrf.LRELU_SLOPE)

    ref = conv(lrelu(x).to(torch.bfloat16))
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= BF16_TILE_TOL * scale
    for wrong in (conv(lrelu(x.to(torch.bfloat16).float())), conv(lrelu(x))):  # rounded before the lrelu; not at all
        assert float((got - wrong).abs().max()) > BF16_TILE_TOL * scale


@pytest.mark.cuda
def test_k1_bf16_sums_are_promoted(cuda_f32):
    """One bf16 convolution at (C, k, d) = (256, 11, 1), 4,096 frames, against
    float64 on the same rounded operands: the kernel's mean error is at most
    3× cuDNN f32's on the same operands (a single truncating chain per output
    read ~6×).  Prints both, and the share of each error signed toward zero."""
    g = torch.Generator().manual_seed(11)
    c, k = 256, 11
    x = torch.randn((1, 4096, c), generator=g).cuda()
    w = (torch.randn((k, c, c), generator=g) * 0.1).to(torch.bfloat16).cuda()
    bias = (torch.randn((c,), generator=g) * 0.1).cuda()
    a = torch.nn.functional.leaky_relu(x, mrf.LRELU_SLOPE).to(torch.bfloat16)
    ref = torch.nn.functional.conv1d(a.double().transpose(1, 2), w.double().permute(2, 1, 0), bias.double(),
                                     padding=k // 2).transpose(1, 2)
    cudnn = torch.nn.functional.conv1d(a.float().transpose(1, 2), w.float().permute(2, 1, 0), bias,
                                       padding=k // 2).transpose(1, 2).double()
    got = mrf.conv_taps(x, w, bias, 1).double()
    e_k, e_c = got - ref, cudnn - ref
    share = {name: float((e * ref.sign()).mean() / e.abs().mean()) for name, e in (("kernel", e_k), ("cudnn", e_c))}
    print(f"one conv (256, 11, 1) against float64: kernel mean {float(e_k.abs().mean()):.3e} (signed toward zero "
          f"{share['kernel']:+.3f}), cuDNN f32 mean {float(e_c.abs().mean()):.3e} ({share['cudnn']:+.3f})")
    assert float(e_k.abs().mean()) <= 3 * float(e_c.abs().mean())


@pytest.mark.cuda
def test_k1_rejects_what_it_cannot_run(cuda_f32):
    x, w = _stage(1, 32, 64, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        mrf.mrf_stage(x.transpose(1, 2).contiguous().transpose(1, 2), w, KERNELS, DILATIONS)
    with pytest.raises(ValueError, match="float32"):
        mrf.mrf_stage(x.double(), w, KERNELS, DILATIONS)
    with pytest.raises(ValueError, match="weight shape"):
        mrf.mrf_stage(x, w, (3, 7, 9), DILATIONS)
    mixed = [mrf.pack_weights(_bf16(w))[0]] + mrf.pack_weights(w)[1:]  # one res-block in bf16, two in f32
    with pytest.raises(ValueError, match="bfloat16"):
        mrf.mrf_stage(x, mixed, KERNELS, DILATIONS)
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
