"""K1's bf16 mode (csrc/mrf_bf16.cu), its layouts held on the CPU: the packed
weight stages, the shared-memory A tile and each tap's view of it, the fused
dilation unit's overlapping tile walk, the one-conv kernel's blocks of one or
more N chunks, and why each tap's sum is promoted.

The kernel itself runs only on the card (tests/test_torch_mrf_cuda.py); these
are index models of what it reads, written from its comments, held against
the contract weights and the plain twin."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from emojivoice_tpu_torch.ops import mrf

BF16 = torch.bfloat16
BM = mrf.BF16_BM  # frames of one conv pass of a block
V1_T = (4096, 32768, 65536, 131072)  # the four stages of a 512-frame utterance
WINDOW_T = (640, 5120, 10240, 20480)  # the four stages of one 80-frame streaming window
RAGGED_T = (333, 1001)


def _round_lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, mrf.LRELU_SLOPE).to(BF16)


@pytest.mark.parametrize("c", [6, 20, 32, 40, 64, 128, 256])
def test_bf16_stages_hold_each_taps_block(c):
    """The packed bytes, read as the kernel copies them (stage (n·k + j)·n_kc + s
    of n·n bf16, [8-channel group][n output rows][8]), give back every weight
    w[j, c_in, c_out] of each tap's (c_in, c_out) block, and zeros beyond C."""
    rng = np.random.default_rng(c)
    n_d, k = 2, 3
    w = torch.from_numpy(rng.normal(size=(n_d, k, c, c)).astype(np.float32)).to(BF16)
    packed = mrf.pack_conv(w)
    n = mrf.bf16_tile(c)
    chunks = -(-c // n)
    assert packed.dtype == BF16 and packed.is_contiguous()
    assert tuple(packed.shape) == (n_d, chunks, k, chunks, n // 8, n, 8)
    flat = packed.reshape(n_d, -1)
    assert flat.shape[1] == k * (chunks * n) ** 2  # the kernel's packed_bytes(C, k) / 2
    padded = F.pad(w.float(), (0, chunks * n - c, 0, chunks * n - c))  # [d][tap][c_in][c_out]
    for d in range(n_d):
        for nc in range(chunks):
            for j in range(k):
                for s in range(chunks):
                    stage = flat[d, ((nc * k + j) * chunks + s) * n * n:][:n * n].float().reshape(n // 8, n, 8)
                    block = stage.permute(0, 2, 1).reshape(n, n)  # [c_in of the slice][c_out of the chunk]
                    want = padded[d, j, s * n:(s + 1) * n, nc * n:(nc + 1) * n]
                    assert torch.equal(block, want)


def _a_tile(x: torch.Tensor, f0: int, rows: int, c: int) -> torch.Tensor:
    """load_tile: element (g·rows + r)·8 + e is round_bf16(lrelu(x[f0 + r, 8g + e])), zero outside [0, T) or
    beyond C; the channels padded to whole n-wide slices."""
    t_len = x.shape[0]
    n = mrf.bf16_tile(c)
    groups = -(-c // n) * n // 8
    tile = torch.zeros((groups, rows, 8), dtype=BF16)
    for r in range(rows):
        t = f0 + r
        if 0 <= t < t_len:
            v = F.pad(_round_lrelu(x[t]).float(), (0, groups * 8 - c)).to(BF16)
            tile[:, r, :] = v.reshape(groups, 8)
    return tile.reshape(-1)


def _descriptor_view(tile: torch.Tensor, start: int, lbo: int, sbo: int) -> torch.Tensor:
    """The 64 × 16 bf16 A operand a no-swizzle K-major descriptor reads: element (m, kk) at byte
    start + (m // 8)·sbo + (m % 8)·16 + (kk // 8)·lbo + (kk % 8)·2."""
    m = torch.arange(64)[:, None]
    kk = torch.arange(16)[None, :]
    byte = start + (m // 8) * sbo + (m % 8) * 16 + (kk // 8) * lbo + (kk % 8) * 2
    assert bool((byte % 2 == 0).all())
    return tile[byte // 2]


@pytest.mark.parametrize("t_len,c,k,d,t0", [(333, 40, 11, 5, 0), (333, 40, 7, 3, 256), (200, 20, 3, 1, 128),
                                             (1001, 64, 11, 1, 896), (90, 6, 5, 2, 0), (300, 128, 3, 5, 128)])
def test_a_tile_and_each_taps_view(t_len, c, k, d, t0):
    """The one-conv kernel's tile (frames t0 − (k/2)·d ...) read through tap j's descriptor (start moved by
    16·j·d bytes, slice s by s·n/8 groups, k-step by 2 groups) is round_bf16(lrelu(x)) shifted by (j − k/2)·d,
    with zero rows at the sequence edges and zero channels beyond C."""
    rng = np.random.default_rng(t_len + c + k)
    x = torch.from_numpy(rng.normal(size=(t_len, c)).astype(np.float32))
    n = mrf.bf16_tile(c)
    h1 = (k // 2) * d
    rows = BM + 2 * h1
    tile = _a_tile(x, t0 - h1, rows, c)
    act = F.pad(_round_lrelu(x).float(), (0, -c % n))
    lbo = rows * 16
    for wg in range(2):
        for j in range(k):
            for s in range(-(-c // n)):
                for step in range(n // 16):
                    start = (64 * wg + j * d) * 16 + s * (n // 8) * lbo + 2 * step * lbo
                    got = _descriptor_view(tile, start, lbo, 128).float()
                    frames = t0 + 64 * wg + torch.arange(64) + (j - k // 2) * d
                    chans = s * n + 16 * step + torch.arange(16)
                    inside = ((frames >= 0) & (frames < t_len))[:, None]
                    want = torch.where(inside, act[frames.clamp(0, t_len - 1)][:, chans], torch.zeros(()))
                    assert torch.equal(got, want)


def _fused_walk(t_len: int, k: int):
    """The fused unit's tiles: block i computes both convs over 128 rows and stores the first 128 − (k − 1),
    frames t0 = i·(128 − (k − 1)) ...; its x tile starts at frame t0 − (k/2) − (k/2)·d."""
    out_rows = BM - (k - 1)
    return [(i * out_rows, min(out_rows, t_len - i * out_rows)) for i in range(-(-t_len // out_rows))]


def _fused_unit_tiled(x, w1, b1, w2, b2, k, d):
    """One dilation unit computed tile by tile as the fused kernel walks it (each tile from its own zero-padded x
    rows and its own h rows), in f32 with the twin's rounding points."""
    t_len = x.shape[0]
    h1, h2 = (k // 2) * d, k // 2
    out = torch.full_like(x, float("nan"))
    for t0, n_out in _fused_walk(t_len, k):
        frames = torch.arange(t0 - h2 - h1, t0 - h2 - h1 + BM + 2 * h1)
        inside = ((frames >= 0) & (frames < t_len))[:, None]
        xt = torch.where(inside, x[frames.clamp(0, t_len - 1)], torch.zeros(()))
        a = F.leaky_relu(xt, mrf.LRELU_SLOPE).to(BF16).float()
        h = F.conv1d(a.T[None], w1.float().permute(2, 1, 0), b1, dilation=d)[0].T  # 128 rows, frames t0 − h2 ...
        h_frames = torch.arange(t0 - h2, t0 - h2 + BM)
        h_in = ((h_frames >= 0) & (h_frames < t_len))[:, None]
        ha = torch.where(h_in, F.leaky_relu(h, mrf.LRELU_SLOPE).to(BF16).float(), torch.zeros(()))
        ha = F.pad(ha.T, (0, 2 * h2)).T  # rows past the 128 feed only rows that are not stored
        o = F.conv1d(ha.T[None], w2.float().permute(2, 1, 0), b2)[0].T[:n_out]
        assert bool(torch.isnan(out[t0:t0 + n_out]).all())  # no frame is written twice
        out[t0:t0 + n_out] = x[t0:t0 + n_out] + o
    return out


@pytest.mark.parametrize("t_len", V1_T + WINDOW_T + RAGGED_T)
@pytest.mark.parametrize("k", [3, 7, 11])
def test_fused_walk_covers_every_frame_once(t_len, k):
    """Every output frame of the v1 stage, window and ragged lengths lies in exactly one fused tile, every tile
    stores at least one frame, and the rows each tile reads stay inside its x and h tiles."""
    seen = np.zeros(t_len, np.int64)
    for t0, n_out in _fused_walk(t_len, k):
        assert 0 < n_out <= BM - (k - 1)
        seen[t0:t0 + n_out] += 1
        # conv_{k,1}'s stored row o reads h rows o ... o + k − 1 < 128 + (k − 1), the h tile's rows
        assert (n_out - 1) + (k - 1) < BM + (k - 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("t_len,c,k,d", [(333, 40, 11, 5), (1001, 20, 7, 3), (300, 64, 3, 1), (130, 32, 11, 1)])
def test_fused_tiles_reproduce_the_unit(t_len, c, k, d):
    """The tile-by-tile unit equals the plain twin's dilation unit (bf16 weights) to f32 rounding: the overlap,
    the zero rows at both edges and the h rows past 128 change nothing."""
    rng = np.random.default_rng(c + k)
    x = torch.from_numpy(rng.normal(size=(t_len, c)).astype(np.float32))
    w1, w2 = (torch.from_numpy((rng.normal(size=(k, c, c)) * 0.05).astype(np.float32)).to(BF16) for _ in range(2))
    b1, b2 = (torch.from_numpy((rng.normal(size=(c,)) * 0.1).astype(np.float32)) for _ in range(2))
    got = _fused_unit_tiled(x, w1, b1, w2, b2, k, d)
    # the twin's stage with one res-block of one unit is (x + unit(x)) / 1
    ref = mrf.mrf_stage_reference(x[None], [(w1[None], b1[None], w2[None], b2[None])], (k,), ((d,),))[0]
    err = (got - ref).abs()
    assert float((err <= 2e-4).float().mean()) >= 0.999 and float(err.max()) < 2e-3


def _one_conv_blocks(b: int, t_len: int, c: int, chunks: int):
    """The one-conv kernel's grid: block i takes frames t0 = (i % n_t)·128 ..., N chunks n_first ... n_last − 1
    (`chunks` of them, fewer in the last block of a row) of sequence i // (n_t·n_blk), and its weight ring reads
    the stages from (n_first·k + 0)·n_kc on, (n_last − n_first)·k·n_kc of them."""
    n = mrf.bf16_tile(c)
    n_n = -(-c // n)
    n_t, n_blk = -(-t_len // BM), -(-n_n // chunks)
    for i in range(n_t * n_blk * b):
        n_first = ((i // n_t) % n_blk) * chunks
        yield i // (n_t * n_blk), (i % n_t) * BM, n_first, min(n_n, n_first + chunks)


@pytest.mark.parametrize("b,t_len,c", [(1, 4096, 256), (8, 4096, 256), (1, 640, 256), (1, 5120, 128),
                                       (3, 333, 40), (3, 1001, 20), (2, 300, 200)])
@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
def test_one_conv_blocks_cover_every_output_once(b, t_len, c, chunks):
    """Every (sequence, frame, output channel) of a conv lies in exactly one one-conv block whatever the number of
    N chunks a block takes, and a block's weight stages, read in ring order from its first chunk's offset, are the
    (chunk, tap, K slice) stages of its own passes in the packing's order."""
    k = 3
    n = mrf.bf16_tile(c)
    n_n = n_kc = -(-c // n)
    seen = np.zeros((b, t_len, n_n * n), np.int64)
    for bz, t0, n_first, n_last in _one_conv_blocks(b, t_len, c, chunks):
        assert 0 <= n_first < n_last <= n_n and n_last - n_first <= chunks
        seen[bz, t0:t0 + BM, n_first * n:n_last * n] += 1
        stages = [(n_first * k * n_kc) + q for q in range((n_last - n_first) * k * n_kc)]
        passes = [(nc, j, s) for nc in range(n_first, n_last) for j in range(k) for s in range(n_kc)]
        assert stages == [(nc * k + j) * n_kc + s for nc, j, s in passes]
    assert (seen == 1).all()


def _truncate(v: np.ndarray) -> np.ndarray:
    """float64 → the f32 number next to it toward zero (the tensor cores' accumulation)."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def test_promoted_sums_err_less_than_one_chain():
    """The numeric model behind the promoted sums: k16 products summed exactly and added to an f32 accumulator
    that truncates toward zero.  One chain over all k·C terms (the earlier design) errs toward zero by most of
    its size; a chain per tap started from zero and added to the f32 sum by round-to-nearest adds (the kernel's
    commit groups) errs over five times less, within twice an f32 sum that rounds every add to nearest (what
    cuDNN's f32 conv is held to), at (C, k) = (256, 11)."""
    rng = np.random.default_rng(0)
    c, k, n_out = 256, 11, 4096
    a = torch.from_numpy(rng.normal(size=(n_out, k, c)).astype(np.float32)).to(BF16).double().numpy()
    w = torch.from_numpy((rng.normal(size=(k, c)) * 0.1).astype(np.float32)).to(BF16).double().numpy()
    prods = a * w  # exact: a bf16 × bf16 product fits f32
    steps = prods.reshape(n_out, k, c // 16, 16).sum(-1)  # one k16 product each, summed exactly
    exact = prods.sum((1, 2))

    chain = np.zeros(n_out, np.float32)
    nearest = np.zeros(n_out, np.float32)
    promoted = np.zeros(n_out, np.float32)
    for j in range(k):
        part = np.zeros(n_out, np.float32)
        for s in range(c // 16):
            chain = _truncate(chain.astype(np.float64) + steps[:, j, s])
            nearest = (nearest.astype(np.float64) + steps[:, j, s]).astype(np.float32)
            part = _truncate(part.astype(np.float64) + steps[:, j, s])
        promoted = promoted + part  # f32, round to nearest

    def mean_err(v):
        return float(np.mean(np.abs(v.astype(np.float64) - exact)))

    toward_zero = float(np.mean((chain - exact) * np.sign(exact)) / mean_err(chain))
    assert toward_zero < -0.8
    assert mean_err(promoted) < mean_err(chain) / 5 and mean_err(promoted) < 2 * mean_err(nearest)


def test_check_takes_the_new_tiling_and_refuses_the_old():
    """``mrf_stage``'s shape check asks for the bf16 stages of ``tile_k_major_bf16``; the earlier
    (n_d, ⌈C/32⌉, k, 4, C, 8) tiling of the same weights is refused."""
    c, k = 40, 3
    x = torch.zeros((1, 8, c))
    w = torch.randn((1, k, c, c)).to(BF16)
    b = torch.zeros((1, c))
    packed = [mrf.PackedResblock(mrf.pack_conv(w), b, mrf.pack_conv(w), b)]
    assert mrf._check(x, packed, (k,), ((1,),)) is True
    old = w.transpose(-1, -2).contiguous()
    old = F.pad(old, (0, -c % 32)).reshape(1, k, c, -1, 4, 8).permute(0, 3, 1, 4, 2, 5).contiguous()
    with pytest.raises(ValueError, match="weight shape"):
        mrf._check(x, [mrf.PackedResblock(old, b, old, b)], (k,), ((1,),))
