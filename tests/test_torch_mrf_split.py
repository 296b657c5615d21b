"""K1's numeric design, held on the CPU: the TF32 split of an f32 number, the
K-major packing of the weights, and why the tensor-core sum takes three
products and not one."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from emojivoice_tpu_torch.ops import mrf

LOW13 = 0x1FFF


def _numbers(seed=0):
    rng = np.random.default_rng(seed)
    body = rng.normal(size=4096).astype(np.float32) * np.float32(10.0) ** rng.integers(-6, 7, 4096).astype(np.float32)
    edge = np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -3e-39, 1.17549435e-38, 3.0e38, -3.0e38, 3.4028235e38,
                     -3.4028235e38, 1e30, -1e-30], np.float32)
    return torch.from_numpy(np.concatenate([body, edge]))


def test_split_parts_are_tf32_numbers():
    hi, lo = mrf.split_tf32(_numbers())
    assert hi.dtype == lo.dtype == torch.float32
    assert not bool((hi.view(torch.int32) & LOW13).any()) and not bool((lo.view(torch.int32) & LOW13).any())
    assert bool(torch.isfinite(hi).all()) and bool(torch.isfinite(lo).all())


def test_split_rounds_to_nearest():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # one TF32 step at 1.0
    above = one + ulp / 2 + np.float32(2.0 ** -23)   # just above the midpoint: up
    below = one + ulp / 2 - np.float32(2.0 ** -23)   # just below it: down (truncation would also give 1.0)
    high = one + ulp - np.float32(2.0 ** -23)        # truncation gives 1.0, rounding 1 + ulp
    t = torch.tensor([above, below, high, -above, -high], dtype=torch.float32)
    hi, lo = mrf.split_tf32(t)
    assert hi.tolist() == [float(one + ulp), 1.0, float(one + ulp), -float(one + ulp), -float(one + ulp)]
    assert float((hi.double() + lo.double() - t.double()).abs().max()) <= 2.0 ** -21


def test_split_sum_is_within_2_to_minus_21():
    t = _numbers(1)
    hi, lo = mrf.split_tf32(t)
    err = (hi.double() + lo.double() - t.double()).abs()
    # relative 2^-21 (hi keeps 11 significant bits, lo 11 more); subnormals keep an absolute step of 2^-136
    assert bool((err <= t.double().abs() * 2.0 ** -21 + 2.0 ** -136).all())
    assert bool((hi[t == 0] == 0).all()) and bool((lo[t == 0] == 0).all())
    assert bool(((hi - t).abs() <= t.abs() * 2.0 ** -11 + 2.0 ** -136).all())


def _stage(c, t_len, seed, kernels=(3, 5), dils=((1, 3), (1, 2))):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, t_len, c)).astype(np.float32))
    weights = [tuple(torch.from_numpy((rng.normal(size=shape) * 0.3).astype(np.float32))
                     for shape in ((len(d), k, c, c), (len(d), c), (len(d), k, c, c), (len(d), c)))
               for k, d in zip(kernels, dils)]
    return x, weights, kernels, dils


@pytest.mark.parametrize("c", [8, 20, 40])
def test_packer_is_k_major_and_splits(c):
    _, weights, _, _ = _stage(c, 8, seed=c)
    for w1, _, w2, _ in weights:
        for w in (w1, w2):
            hi, lo = mrf.pack_k_major(w)
            k_major = w.permute(0, 1, 3, 2)  # [dilation][tap][c_out][c_in]
            assert hi.shape == k_major.shape and hi.is_contiguous() and lo.is_contiguous()
            want_hi, want_lo = mrf.split_tf32(k_major.contiguous())
            assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
            assert float((hi + lo - k_major).abs().max()) <= float(w.abs().max()) * 2.0 ** -21


@pytest.mark.parametrize("c", [8, 20, 40])
def test_tiling_keeps_every_weight_where_the_kernel_reads_it(c):
    """tiled[d, slice, tap, part, group, c_out, e] is part[d, tap, c_out,
    32·slice + 4·group + e], zero where that c_in does not exist."""
    _, weights, kernels, dils = _stage(c, 8, seed=c)
    packed = mrf.pack_weights(weights)
    assert len(packed) == len(weights)
    for rb, (w1, b1, w2, b2), k, d in zip(packed, weights, kernels, dils):
        n_slices = -(-c // mrf.KC)
        for tiled, w in ((rb.w1, w1), (rb.w2, w2)):
            assert tiled.shape == (len(d), n_slices, k, 2, 8, c, 4) and tiled.is_contiguous()
            parts = torch.stack(mrf.pack_k_major(w), dim=2)  # (n_d, k, 2, c_out, c_in)
            padded = F.pad(parts, (0, n_slices * mrf.KC - c))
            back = tiled.permute(0, 2, 3, 5, 1, 4, 6).reshape(len(d), k, 2, c, n_slices * mrf.KC)
            assert torch.equal(back, padded)
        assert torch.equal(rb.b1, b1) and torch.equal(rb.b2, b2)


def _emulated_stage(x, weights, kernels, dils, products):
    """The MRF stage with every conv computed as K1 computes it: operands split
    in TF32 parts, `products` of the part-products summed (float64 stands in
    for the tensor core's exact products and f32 accumulator)."""
    def conv(t, w, b, k, d):
        a_hi, a_lo = mrf.split_tf32(t)
        w_hi, w_lo = mrf.split_tf32(w.permute(2, 1, 0).contiguous())  # (c_out, c_in, k), as F.conv1d takes it
        pairs = [(a_hi, w_hi), (a_hi, w_lo), (a_lo, w_hi)][:products]
        out = sum(F.conv1d(a.double(), ww.double(), padding=(k * d - d) // 2, dilation=d) for a, ww in pairs)
        return (out + b.double()[None, :, None]).float()

    xc = x.transpose(1, 2)
    total = None
    for (w1, b1, w2, b2), k, ds in zip(weights, kernels, dils):
        cur = xc
        for di, d in enumerate(ds):
            t = conv(F.leaky_relu(cur, mrf.LRELU_SLOPE), w1[di], b1[di], k, d)
            t = conv(F.leaky_relu(t, mrf.LRELU_SLOPE), w2[di], b2[di], k, 1)
            cur = cur + t
        total = cur if total is None else total + cur
    return (total / len(kernels)).transpose(1, 2)


@pytest.mark.parametrize("c", [8, 20])
def test_three_products_reach_f32_accuracy_and_one_does_not(c):
    x, weights, kernels, dils = _stage(c, 40, seed=10 + c)
    ref = mrf.mrf_stage_reference(x, weights, kernels, dils)
    three = _emulated_stage(x, weights, kernels, dils, products=3)
    one = _emulated_stage(x, weights, kernels, dils, products=1)
    torch.testing.assert_close(three, ref, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(one, ref, atol=1e-5, rtol=1e-5)
    assert float((one - ref).abs().max()) > 10 * float((three - ref).abs().max())
