// K1, bf16 mode: HiFi-GAN MRF res-block (ResBlock1) on Hopper with bf16
// tensor-core products and f32 sums, one launch per dilation unit.
//
// Replaces: the bf16 mode of emojivoice_tpu/ops/pallas_mrf.py::_resblock_pallas
// (the Pallas TPU kernel at pallas_mrf.py:105, reached through
// mrf_stage_pallas(compute_dtype=bf16), :171,192-194).  With bf16 weights its
// _conv_same (:64-86) rounds the masked, leaky-ReLU'd activation to bf16 at each
// tap's dot and multiplies once, bf16 × bf16 → f32, adding the taps' dots in
// f32; bias, residual, the res-block mean, x, the intermediate and out stay f32.
// One dilation unit of a res-block is
//
//   x ← x + conv_{k,1}(round(lrelu(conv_{k,d}(round(lrelu(x))) + b1))) + b2
//
// with zero padding at the true sequence edges before each conv, and the
// stage's mean over res-blocks folded into the last unit's epilogue.
//
// What bounds it on an H100.  A conv is 2·k·C²·T operations; one v1 stage at
// 512 mel frames is 34-135 GFLOP, 0.03-0.14 ms at 989 TFLOP/s, against 0.01-0.02
// ms of x read and out written once: operations.  But at that rate every (B, T,
// C) f32 tensor that goes through device memory costs as much as the products
// of a C ≤ 64 conv, and each activation that is rebuilt per tap costs the
// integer and conversion pipes k times over.  So the design keeps everything it
// can on chip:
//   * Round once.  A block owns BM = 128 frames of one conv pass (two consumer
//     warpgroups of 64 rows).  It reads its x rows (plus the halo) once from
//     global memory, applies the lrelu, rounds to bf16 (cvt.rn.bf16x2.f32, round
//     to nearest even as JAX's astype) and stores them once into a bf16 operand
//     tile in shared memory; rows outside [0, T) and channels beyond C are zero.
//     The tile is no-swizzle K-major, [8-channel group][row][8 × bf16]: each
//     core matrix (8 rows × 16 bytes) is 128 contiguous bytes, and a shift of s
//     rows moves a descriptor's start by 16·s bytes.  Every tap j is then one
//     descriptor on the same tile shifted by j·d rows: A comes from shared
//     memory (wgmma's SS form), no fragment is built in registers at all.  The
//     tensor cores read each core matrix as one 128-byte line, which is free of
//     bank conflicts whatever the shift; the loader writes 16 bytes a thread
//     with consecutive threads on consecutive rows of one group, 512 contiguous
//     bytes a warp, also free of conflicts.
//   * Promoted sums.  The tensor cores' f32 accumulation truncates toward zero
//     (a single chain over k·C terms errs by −0.9 of its size, six times cuDNN's
//     f32 error at k = 11, C = 256).  Each commit group is one tap's chain of
//     k16 products over its K slices (at most half the weight ring), started
//     from zero in a partial accumulator set (the first product writes it,
//     scale-d 0), and is added to the running f32 sum with ordinary
//     round-to-nearest adds, as _conv_same adds its per-tap dots (0.32× cuDNN's
//     mean error there on an H100, PERF.md).  No fragment lives in registers, so
//     those registers hold the partials.  With two partial sets (BN = 32) one
//     group stays in flight (wgmma.wait_group 1) while the previous one is
//     promoted; at BN = 64 one set keeps a thread within the 128 registers of
//     two blocks an SM, and the SM's other three warpgroups overlap the
//     promotion.
//   * A fused dilation unit.  One launch computes the whole unit: conv_{k,d}
//     over 128 rows for every output channel (BN at a time), its epilogue adds
//     b1, applies the lrelu, zeroes rows outside [0, T) and stores
//     round_bf16(·) into a second bf16 tile in shared memory, which is the A
//     operand of conv_{k,1}: h never reaches device memory.  conv_{k,1} runs
//     over the same 128 rows, of which the first 128 − (k − 1) are whole, so the
//     output tiles step by 128 − (k − 1) frames and overlap by k − 1 (at most
//     8 % recomputed, k = 11).  A unit reads x once and writes out once (plus the
//     residual's and the mean's reads): 9 launches a stage instead of 18.
//   * Enough tiles, and not too many.  The fused unit needs every output
//     channel of conv_{k,d} in one block, so at C = 256, B = 1 a 4,096-frame
//     stage has 35 tiles for 132 SMs, and an 80-frame streaming window fewer
//     still; and at C = 256 its two 256-channel tiles leave room for one block
//     an SM.  There, and at C = 128 with few tiles, the launcher takes the
//     one-conv kernel twice (h through device memory as f32).  A one-conv block
//     computes 1, 2 or 4 N chunks of BN = 64 output channels, one pass each over
//     the x tile it loaded and rounded once: one chunk where blocks are scarce,
//     more where they are plenty, so that fewer blocks load and round each x
//     row.  Both rules (unit_fused(), conv_chunks()) are set by the same-call
//     measurement of kernels/probe_k1.py.
//   * Copies.  The weights arrive one (N chunk, tap, K slice) stage at a time
//     by one bulk copy (cp.async.bulk, completion on an mbarrier) into a ring of
//     up to 8 stages; they are packed once outside the kernel in exactly that
//     order (ops/mrf.py::tile_k_major_bf16), [N chunk][tap][K slice][8-channel
//     group][BN][8].  There is no copying warp: the warp that releases a slot
//     last starts the copy that refills it (Ring), so a block is the two
//     warpgroups alone and keeps 128 registers a thread at two blocks an SM (a
//     ninth warp cut that to 96 and made the fused unit spill).  x is read by
//     the warpgroups themselves, once per tile, converted on the way in: an f32
//     TMA box would need twice the shared memory and a second pass to round.
//     Blocks are not persistent; two blocks an SM (where the shared memory
//     allows) overlap one block's loads with the other's products.
// C that is no multiple of 32 or 64 is zero-padded in shared memory and in the
// packed weights, never in the activations in global memory; C that is no
// multiple of 4 takes scalar loads.
//
// Plain C interface (built with nvcc into a shared library, bound through
// ctypes); launches on the caller's stream and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

#include "k1_common.cuh"

// -DK1_PHASE_CLOCKS: consumer thread 0 of block 0 sums clock64() cycles per phase (loading and rounding the
// activations, waiting for weights, products in flight, promoting partial sums, epilogues) and prints them when the
// block ends; kernels/probe_k1.py builds this variant.
#ifdef K1_PHASE_CLOCKS
#include <cstdio>
#endif

namespace {

constexpr int BM = 128;                 // frames of one conv pass: two consumer warpgroups of 64 rows
constexpr int kConsumers = 256;        // the block: two warpgroups, no copying warp
constexpr int kWarps = kConsumers / 32;
constexpr int kMaxStages = 8;           // weight ring depth, at most
constexpr int kBarBytes = 128;          // the mbarriers full[8], then the slots' release counts [8]
constexpr int kSmemHalf = 115712;       // two blocks an SM: (228 KB − 2 × 1 KB reserved) / 2

enum Phase : int { kLoad = 0, kWaitW, kProducts, kPromote, kEpilogueH, kEpilogue, kPhases };

// output channels of a block's pass and input channels of a weight stage: one rule, so one packing serves both the
// fused and the one-conv kernel (ops/mrf.py::bf16_tile mirrors it)
__host__ __device__ constexpr int tile_n(int C) { return C <= 32 ? 32 : 64; }

struct Clock {
#ifdef K1_PHASE_CLOCKS
  long long c, t[kPhases], start;
  __device__ __forceinline__ void begin() {
    for (int p = 0; p < kPhases; ++p) t[p] = 0;
    start = c = clock64();
  }
  __device__ __forceinline__ void tic() { c = clock64(); }
  __device__ __forceinline__ void toc(int p) { t[p] += clock64() - c; }
#else
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void tic() {}
  __device__ __forceinline__ void toc(int) {}
#endif
};

// this thread's ordinary shared-memory stores, made visible to the tensor cores' (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// the block's two warpgroups
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// d (64 × N, f32, registers) += a (64 × 16 bf16) · b (16 × N bf16), both from shared memory, K-major
// (imm-trans-a = imm-trans-b = 0)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, 1, 1, 1, 0, 0;\n"
      : K1_D16(0)
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 0, 0;\n"
      : K1_D16(0), K1_D16(16)
      : "l"(da), "l"(db));
}

// d (64 × N, f32) = a · b, the chain's first product: d is only written, so a partial set holds no value between
// one group's promotion and the next group's start, and its registers serve the epilogue meanwhile
template <int N>
__device__ __forceinline__ void wgmma_ss_zero(float (&d)[N / 2], uint64_t da, uint64_t db);

#define K1_O4(i) "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3])
#define K1_O16(i) K1_O4(i), K1_O4(i + 4), K1_O4(i + 8), K1_O4(i + 12)

template <>
__device__ __forceinline__ void wgmma_ss_zero<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, 0, 1, 1, 0, 0;\n"
      : K1_O16(0)
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_ss_zero<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 0, 1, 1, 0, 0;\n"
      : K1_O16(0), K1_O16(16)
      : "l"(da), "l"(db));
}

// lrelu of two f32 values, rounded to nearest even into one bf16x2 word: `lo` (the lower channel) in the low half
__device__ __forceinline__ uint32_t lrelu_bf16x2(float lo, float hi) {
  lo = lo > 0.f ? lo : lo * SLOPE;
  hi = hi > 0.f ? hi : hi * SLOPE;
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Rows [0, R) of a bf16 operand tile: row r is round_bf16(lrelu(src[bz, f0 + r, :])), zero outside [0, T) and
// beyond C, in G groups of 8 channels laid out [group][row][8].  Element i = g·R + r of the tile is 16 bytes, so
// consecutive consumer threads store consecutive 16-byte rows of one group.  A thread issues the loads of LB
// elements before it converts any, so LB device-memory latencies overlap instead of following each other.
constexpr int LB = 4;
__device__ __forceinline__ void load_tile(uint4* tile, const float* src, int bz, int T, int C, int f0, int R, int G,
                                          int ctid) {
  const float* sb = src + static_cast<size_t>(bz) * T * C;
  const bool vec = (C & 3) == 0;  // rows 16-byte aligned
  const int n = R * G;
  for (int i0 = ctid; i0 < n; i0 += LB * kConsumers) {
    float v[LB][8];
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      const int i = i0 + u * kConsumers;
      const int g = i / R, r = i - g * R;
      const int t = f0 + r, c0 = 8 * g;
      if (i < n && t >= 0 && t < T && vec && c0 + 8 <= C) {
        const float4* p = reinterpret_cast<const float4*>(sb + static_cast<size_t>(t) * C + c0);
        const float4 a = p[0], b = p[1];
        v[u][0] = a.x; v[u][1] = a.y; v[u][2] = a.z; v[u][3] = a.w;
        v[u][4] = b.x; v[u][5] = b.y; v[u][6] = b.z; v[u][7] = b.w;
      } else {
        const bool in = i < n && t >= 0 && t < T;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] = (in && c0 + e < C) ? sb[static_cast<size_t>(t) * C + c0 + e] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      const int i = i0 + u * kConsumers;
      if (i < n)
        tile[i] = make_uint4(lrelu_bf16x2(v[u][0], v[u][1]), lrelu_bf16x2(v[u][2], v[u][3]),
                             lrelu_bf16x2(v[u][4], v[u][5]), lrelu_bf16x2(v[u][6], v[u][7]));
    }
  }
}

// A partial set, read only after the wait that completed its products, added into the running sum S.
template <int BN>
__device__ __forceinline__ void promote(float (&S)[BN / 2], float (&p)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    asm volatile("" : "+f"(p[i])::"memory");
    S[i] += p[i];
  }
}

// The weight ring, fed without a copying warp: stage q of the block's sequence (every (N chunk, tap, K slice) of its
// passes, in the order they are consumed) goes to slot q % n_stages; the consumer warp that releases a slot last
// starts the copy of stage q + n_stages into it (one bulk copy, completion on the slot's mbarrier).  So no warp
// waits to start a copy, and a block is two warpgroups: 128 registers a thread at two blocks an SM.
template <int BN>
struct Ring {
  static constexpr int STAGE = BN * BN * 2;  // one stage: KC = BN input × BN output channels, bf16
  uint32_t base, bar0;                       // the slots; mbarrier full[s] at bar0 + 8·s
  uint32_t* count;                           // releases of slot s so far, by consumer warps
  const uint8_t *w1, *w2;                    // stages [0, n1) from w1, then from w2
  int n1, total, n_stages;

  __device__ __forceinline__ uint32_t full(int s) const { return bar0 + 8u * s; }
  __device__ __forceinline__ void copy(int q, int s) const {
    const uint8_t* src = q < n1 ? w1 + static_cast<size_t>(q) * STAGE : w2 + static_cast<size_t>(q - n1) * STAGE;
    mbar_arrive_expect_tx(full(s), STAGE);
    bulk_copy(base + static_cast<uint32_t>(s) * STAGE, src, STAGE, full(s));
  }
  // a consumer warp is done with slot s in its round r (its products that read it have completed)
  __device__ __forceinline__ void release(int s, int r, int lane) const {
    __syncwarp();
    if (lane == 0) {
      // acquire-release: the last warp's copy is ordered after every warp's products that read the slot
      uint32_t before;
      asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n" : "=r"(before) : "r"(smem_u32(count + s)) : "memory");
      if (before == static_cast<uint32_t>(kWarps * (r + 1) - 1)) {
        const int q = (r + 1) * n_stages + s;
        if (q < total) copy(q, s);
      }
    }
  }
};

// One K slice c of tap j: wait for its weight stage, then KS k16 products into p (the first from zero if `first`)
// with A the bf16 tile at a_base (R rows) from row row0 + j·d.
template <int BN>
__device__ __forceinline__ void issue(float (&p)[BN / 2], uint32_t a_base, int R, int row0, int d, int j, int c,
                                      int first, const Ring<BN>& ring, int slot, int round, Clock& clk) {
  constexpr int KC = BN, KS = KC / 16;
  const uint32_t lbo_a = static_cast<uint32_t>(R) * 16u;
  clk.tic();
  mbar_wait(ring.full(slot), round & 1);
  clk.toc(kWaitW);
  clk.tic();
  // tap j: the tile from row row0 + j·d; slice c: its 8-channel groups c·KC/8 ...
  const uint32_t a = a_base + static_cast<uint32_t>(row0 + j * d) * 16u + static_cast<uint32_t>(c * (KC / 8)) * lbo_a;
  const uint32_t b = ring.base + static_cast<uint32_t>(slot) * Ring<BN>::STAGE;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint64_t da = make_desc(a + 2u * s * lbo_a, lbo_a, 128u), db = make_desc(b + 2u * s * BN * 16u, BN * 16u, 128u);
    if (s == 0 && first)
      wgmma_ss_zero<BN>(p, da, db);
    else
      wgmma_ss<BN>(p, da, db);
  }
}

// One conv pass of a consumer warpgroup over its 64 rows × BN columns: S = Σ_tap Σ_slice A · W, the weight stages
// arriving in the ring in (tap, slice) order.  Each group's chain starts from zero in a partial set P and is
// promoted into S by f32 adds.
template <int BN, int NP>
__device__ __forceinline__ void conv_pass(float (&S)[BN / 2], float (&P)[NP][BN / 2], uint32_t a_base, int R,
                                          int row0, int d, int k, int n_kc, const Ring<BN>& ring, int& slot,
                                          int& round, int lane, Clock& clk) {
  const int n_stages = ring.n_stages;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) S[i] = 0.f;
  if constexpr (NP == 1) {
    // a group: the K slices of one tap (at most half the ring), one chain from zero, promoted after it completes,
    // as _conv_same adds one dot per tap.  A group's slots are released after the next group's products are
    // issued, so the release's round trip to shared memory overlaps them; the ring holds both groups.
    const int chain = min(max(n_stages / 2, 1), n_kc);
    const int per_tap = (n_kc + chain - 1) / chain;
    int held_slot = 0, held_round = 0, held = 0;  // the previous group's slots, not yet released
    auto release_held = [&]() {
      for (int cc = 0; cc < held; ++cc) {
        ring.release(held_slot, held_round, lane);
        if (++held_slot == n_stages) { held_slot = 0; ++held_round; }
      }
    };
    for (int g = 0; g < k * per_tap; ++g) {
      const int j = g / per_tap, c0 = (g - j * per_tap) * chain, n = min(chain, n_kc - c0);
      const int first_slot = slot, first_round = round;
      for (int cc = 0; cc < n; ++cc) {
        issue<BN>(P[0], a_base, R, row0, d, j, c0 + cc, cc == 0, ring, slot, round, clk);
        if (++slot == n_stages) { slot = 0; ++round; }
      }
      wgmma_commit();
      clk.toc(kProducts);
      clk.tic();
      release_held();
      held_slot = first_slot, held_round = first_round, held = n;
      clk.toc(kPromote);
      clk.tic();
      wgmma_wait<0>();
      clk.toc(kProducts);
      clk.tic();
      promote<BN>(S, P[0]);
      clk.toc(kPromote);
    }
    release_held();
  } else {
    // two partial sets: a group is one slice of one tap, promoted while the next group runs
    int prev = 0, prev_round = 0;
    const int n_groups = k * n_kc;
    for (int g0 = 0; g0 < n_groups; g0 += NP) {
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int g = g0 + q;
        if (g < n_groups) {
          const int j = g / n_kc, c = g - j * n_kc;
          issue<BN>(P[q], a_base, R, row0, d, j, c, 1, ring, slot, round, clk);
          wgmma_commit();
          if (g > 0) {
            wgmma_wait<1>();  // the previous group is done; this one runs on while it is promoted
            clk.toc(kProducts);
            clk.tic();
            promote<BN>(S, P[q ^ 1]);
            ring.release(prev, prev_round, lane);
            clk.toc(kPromote);
          } else {
            clk.toc(kProducts);
          }
          prev = slot;
          prev_round = round;
          if (++slot == n_stages) { slot = 0; ++round; }
        }
      }
    }
    clk.tic();
    wgmma_wait<0>();
    clk.toc(kProducts);
    clk.tic();
    if ((n_groups - 1) & 1) promote<BN>(S, P[1]); else promote<BN>(S, P[0]);
    ring.release(prev, prev_round, lane);
    clk.toc(kPromote);
  }
}

// The running sum S of a warpgroup's rows (frames t0 + row, rows ≥ out_rows or frames ≥ T not stored) and columns
// co0 ..., plus the bias, through the epilogue `mode` into out.  For even C a thread loads the residuals (and,
// accumulating, the outputs) of EB column groups before it stores any: their latencies overlap, and an element
// that res and out share is still read before it is written, by the same thread.
template <int BN>
__device__ __forceinline__ void store_out(const float (&S)[BN / 2], int co0, const float* bias, const float* res,
                                          float* out, int bz, int T, int C, int t0, int out_rows, int frag_row,
                                          int frag_col, int mode, float scale) {
  const size_t batch_off = static_cast<size_t>(bz) * T * C;
  constexpr int EB = 4;
  if ((C & 1) == 0) {  // co is even, so a pair is 8-byte aligned and both columns exist
#pragma unroll
    for (int i0 = 0; i0 < BN / 8; i0 += EB) {
      float2 r[EB][2], p[EB][2], bb[EB];
#pragma unroll
      for (int u = 0; u < EB; ++u) {
        const int co = co0 + 8 * (i0 + u) + 2 * frag_col;
        bb[u] = co < C ? *reinterpret_cast<const float2*>(bias + co) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < EB; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int co = co0 + 8 * (i0 + u) + 2 * frag_col, row = frag_row + 8 * h, t = t0 + row;
          const bool in = co < C && row < out_rows && t < T;
          const size_t o = batch_off + static_cast<size_t>(in ? t : 0) * C + (in ? co : 0);
          r[u][h] = (in && mode != kStore) ? *reinterpret_cast<const float2*>(res + o) : make_float2(0.f, 0.f);
          p[u][h] = (in && mode == kMeanAcc) ? *reinterpret_cast<const float2*>(out + o) : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int u = 0; u < EB; ++u) {
        const int i = i0 + u, co = co0 + 8 * i + 2 * frag_col;
        if (co >= C) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = frag_row + 8 * h, t = t0 + row;
          if (row >= out_rows || t >= T) continue;
          float v0 = S[4 * i + 2 * h] + bb[u].x + r[u][h].x, v1 = S[4 * i + 2 * h + 1] + bb[u].y + r[u][h].y;
          if (mode >= kMeanFirst) { v0 = v0 * scale + p[u][h].x; v1 = v1 * scale + p[u][h].y; }
          *reinterpret_cast<float2*>(out + batch_off + static_cast<size_t>(t) * C + co) = make_float2(v0, v1);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int co = co0 + 8 * i + 2 * frag_col;
    if (co >= C) continue;
    const bool two = co + 1 < C;
    const float bias0 = bias[co], bias1 = two ? bias[co + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = frag_row + 8 * h, t = t0 + row;
      if (row >= out_rows || t >= T) continue;
      const size_t o = batch_off + static_cast<size_t>(t) * C + co;
      float v0 = S[4 * i + 2 * h] + bias0, v1 = S[4 * i + 2 * h + 1] + bias1;
      if (mode != kStore) { v0 += res[o]; if (two) v1 += res[o + 1]; }
      if (mode >= kMeanFirst) { v0 *= scale; v1 *= scale; }
      if (mode == kMeanAcc) { v0 += out[o]; if (two) v1 += out[o + 1]; }
      out[o] = v0;
      if (two) out[o + 1] = v1;
    }
  }
}

// One block: the fused unit (FUSED, out = res + conv_{k,1}(round(lrelu(conv_{k,d}(round(lrelu(x))) + b1))) + b2 on
// 128 − (k − 1) frames), or one conv (out = conv_{k,d}(round(lrelu(x))) + b1 on 128 frames × `chunks` N chunks of
// BN channels, one pass each over the same x tile), each with the epilogue `mode`.  Grid: one block per tile,
// batch-major.
template <int BN, bool FUSED>
__global__ void __launch_bounds__(kConsumers, 2)
k1_bf16_unit_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w1, const float* __restrict__ b1,
                    const uint8_t* __restrict__ w2, const float* __restrict__ b2, const float* res, float* out,
                    int T, int C, int k, int dil, int mode, float scale, int n_stages, int chunks) {
  constexpr int KC = BN, STAGE = Ring<BN>::STAGE;
  // partial sets: two at BN = 32, one group in flight during a promotion (one set was slower on an H100); one at
  // BN = 64, where a second made ptxas serialize the products (C7514) and more than doubled a C = 128 stage's time,
  // and where two 32-column chains in place of one were slower at every stage shape
  constexpr int NP = BN == 32 ? 2 : 1;
  extern __shared__ __align__(128) uint8_t smem[];
  const int n_kc = (C + KC - 1) / KC, n_n = n_kc;  // K slices and N chunks (KC = BN)
  const int G = n_kc * (KC / 8);                   // 8-channel groups of a tile row, C padded to whole slices
  const int h1 = (k / 2) * dil, h2 = k / 2;
  const int rows_x = BM + 2 * h1, rows_h = BM + 2 * h2;
  const int out_rows = FUSED ? BM - 2 * h2 : BM;
  const int n_t = (T + out_rows - 1) / out_rows;
  const int n_blk = FUSED ? 1 : (n_n + chunks - 1) / chunks;  // blocks along the output channels
  const int tile = blockIdx.x;
  const int t0 = (tile % n_t) * out_rows;
  // the N chunks of the block's passes: every one for the fused unit, `chunks` of them for the one-conv kernel
  const int n_first = FUSED ? 0 : ((tile / n_t) % n_blk) * chunks;
  const int n_last = FUSED ? n_n : min(n_n, n_first + chunks);
  const int bz = tile / (n_t * n_blk);
  // x row r is frame t0 − h2 − h1 + r (fused: conv_{k,d} runs over frames t0 − h2 ...), or t0 − h1 + r
  const int f0 = t0 - (FUSED ? h2 : 0) - h1;

  const uint32_t bar0 = smem_u32(smem);
  uint8_t* ring = smem + kBarBytes;
  uint8_t* xs = ring + static_cast<size_t>(n_stages) * STAGE;
  uint8_t* hs = xs + static_cast<size_t>(rows_x) * G * 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int per_pass = k * n_kc;  // weight stages of one N chunk of one conv
  const Ring<BN> wring{smem_u32(ring), bar0, reinterpret_cast<uint32_t*>(smem + 8 * kMaxStages),
                       w1 + static_cast<size_t>(n_first) * per_pass * STAGE, w2, n_n * per_pass,
                       (FUSED ? 2 * n_n : n_last - n_first) * per_pass, n_stages};
  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(wring.full(s), 1);
      wring.count[s] = 0;
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)  // the ring's first round; each later stage is started by the release of its slot
    for (int q = 0; q < min(n_stages, wring.total); ++q) wring.copy(q, q);

  Clock clk;
  clk.begin();
  const int wg = warp >> 2;
  const int frag_row = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // accumulator rows frag_row, + 8
  const int frag_col = lane & 3;                                   // columns 8·i + 2·frag_col, + 1
  clk.tic();
  load_tile(reinterpret_cast<uint4*>(xs), x, bz, T, C, f0, rows_x, G, tid);
  if (FUSED) {  // h rows past the 128 computed ones feed only the conv_{k,1} rows that are not stored: zero them
    uint4* h4 = reinterpret_cast<uint4*>(hs);
    for (int i = tid; i < G * 2 * h2; i += kConsumers) h4[(i / (2 * h2)) * rows_h + BM + i % (2 * h2)] = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();
  consumer_sync();
  clk.toc(kLoad);

  float S[BN / 2], P[NP][BN / 2];
  int slot = 0, round = 0;

  if (FUSED) {
    // conv_{k,d} on 128 rows (frames t0 − h2 + row), every N chunk; its epilogue writes round(lrelu(h + b1)) into
    // the h tile, zero outside [0, T) as _conv_same's maskv makes it
    for (int n = 0; n < n_n; ++n) {
      conv_pass<BN, NP>(S, P, smem_u32(xs), rows_x, 64 * wg, dil, k, n_kc, wring, slot, round, lane, clk);
      clk.tic();
      float2 bb[BN / 8];  // the biases first: no load waits behind the stores
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int co = n * BN + 8 * i + 2 * frag_col;  // < the padded width; weights and bias beyond C give 0
        bb[i] = make_float2(co < C ? b1[co] : 0.f, co + 1 < C ? b1[co + 1] : 0.f);
      }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int co = n * BN + 8 * i + 2 * frag_col;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = frag_row + 8 * h, t = t0 - h2 + row;
          const uint32_t v = (t >= 0 && t < T) ? lrelu_bf16x2(S[4 * i + 2 * h] + bb[i].x, S[4 * i + 2 * h + 1] + bb[i].y) : 0u;
          // 8 rows × 4 column pairs of a warp: 128 contiguous bytes of one group, no bank conflict
          *reinterpret_cast<uint32_t*>(hs + (static_cast<size_t>(co >> 3) * rows_h + row) * 16 + (co & 7) * 2) = v;
        }
      }
      clk.toc(kEpilogueH);
    }
    fence_proxy_async();
    consumer_sync();  // conv_{k,1} reads the other warpgroup's rows too
    for (int n = 0; n < n_n; ++n) {
      conv_pass<BN, NP>(S, P, smem_u32(hs), rows_h, 64 * wg, 1, k, n_kc, wring, slot, round, lane, clk);
      clk.tic();
      store_out<BN>(S, n * BN, b2, res, out, bz, T, C, t0, out_rows, frag_row, frag_col, mode, scale);
      clk.toc(kEpilogue);
    }
  } else {
    // the block's N chunks in turn, all from the one x tile (their weight stages lie in order in the packing)
    for (int n = n_first; n < n_last; ++n) {
      conv_pass<BN, NP>(S, P, smem_u32(xs), rows_x, 64 * wg, dil, k, n_kc, wring, slot, round, lane, clk);
      clk.tic();
      store_out<BN>(S, n * BN, b1, res, out, bz, T, C, t0, out_rows, frag_row, frag_col, mode, scale);
      clk.toc(kEpilogue);
    }
  }
#ifdef K1_PHASE_CLOCKS
  if (blockIdx.x == 0 && tid == 0)
    printf("K1 bf16 phases, block 0 thread 0, %s BN=%d partial sets %d, %d N chunks, C=%d k=%d d=%d, %d weight "
           "stages: load %lld wait_w %lld products %lld promote %lld epilogue_h %lld epilogue %lld of %lld cycles\n",
           FUSED ? "fused unit" : "one conv", BN, NP, n_last - n_first, C, k, dil, n_stages, clk.t[kLoad],
           clk.t[kWaitW], clk.t[kProducts], clk.t[kPromote], clk.t[kEpilogueH], clk.t[kEpilogue],
           clock64() - clk.start);
#endif
}

struct UnitArgs {
  const float* x;
  const void *w1, *w2;  // packed bf16 weights of conv_{k,d} and conv_{k,1}; w2 unused by the one-conv kernel
  const float *b1, *b2, *res;
  float* out;
  int B, T, C, k, dil, mode;
  float scale;
  cudaStream_t stream;
};

size_t tile_bytes(int rows, int C) {
  const int kc = tile_n(C);
  return static_cast<size_t>(rows) * ((C + kc - 1) / kc) * kc * 2;
}

// shared memory of a block without its weight ring
size_t fixed_bytes(int C, int k, int dil, bool fused) {
  return kBarBytes + tile_bytes(BM + 2 * (k / 2) * dil, C) + (fused ? tile_bytes(BM + 2 * (k / 2), C) : 0);
}

#ifndef K1_BF16_ROUTE
#define K1_BF16_ROUTE 0  // 0 the shape rule; 1 every unit fused; 2 every unit as two one-conv launches
#endif
#ifndef K1_BF16_CHUNKS
#define K1_BF16_CHUNKS 0  // 0 the shape rule; n: n N chunks a one-conv block (at most the chunks of C)
#endif

// N chunks of BN output channels a one-conv block computes from its x tile: more chunks load and round each x row
// for fewer blocks, fewer chunks give more blocks.  The rule, set by kernels/probe_k1.py's same-call measurement
// (an H100, PERF.md): the most chunks (1, 2, 4) that still leave two blocks on 15/16 of the SMs.  A C = 256 stage
// of 4,096 frames by 1, 2 and 4 chunks a block: B = 1 0.48 / 0.75 / 1.29 ms, B = 2 0.70 / 0.77 / 1.35, B = 4
// 1.36 / 1.13 / 1.42, B = 8 2.69 / 2.31 / 2.01, B = 32 9.46 / 8.30 / 7.95; a C = 128 stage of 32,768 frames at
// B = 1: 0.85 / 0.68.
int conv_chunks(int B, int T, int C) {
  const int n_n = (C + tile_n(C) - 1) / tile_n(C);
  if (K1_BF16_CHUNKS > 0) return std::min(K1_BF16_CHUNKS, n_n);
  const long rows = static_cast<long>((T + BM - 1) / BM) * B;  // tiles along the frames, all sequences
  int chunks = 1;
  while (2 * chunks <= n_n && 8 * rows * ((n_n + 2 * chunks - 1) / (2 * chunks)) >= 15L * sm_count()) chunks *= 2;
  return chunks;
}

template <int BN, bool FUSED>
cudaError_t launch_unit(const UnitArgs& a) {
  constexpr size_t STAGE = static_cast<size_t>(BN) * BN * 2;
  const size_t fixed = fixed_bytes(a.C, a.k, a.dil, FUSED);
  if (fixed + 2 * STAGE > kSmemLimit) return cudaErrorInvalidValue;
  // the deepest ring (at most 8 stages) that still leaves room for a second block on the SM, else the deepest
  // that fits
  const size_t limit = fixed + 2 * STAGE <= kSmemHalf ? kSmemHalf : kSmemLimit;
  const int n_stages = static_cast<int>(std::min<size_t>(kMaxStages, (limit - fixed) / STAGE));
  const size_t smem = fixed + n_stages * STAGE;
  auto kernel = k1_bf16_unit_kernel<BN, FUSED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int out_rows = FUSED ? BM - (a.k - 1) : BM;
  const int chunks = FUSED ? 1 : conv_chunks(a.B, a.T, a.C), n_n = (a.C + BN - 1) / BN;
  const long tiles = static_cast<long>((a.T + out_rows - 1) / out_rows) * (FUSED ? 1 : (n_n + chunks - 1) / chunks) * a.B;
  if (tiles > 0x7FFFFFFFL) return cudaErrorInvalidValue;
  kernel<<<static_cast<int>(tiles), kConsumers, smem, a.stream>>>(
      a.x, static_cast<const uint8_t*>(a.w1), a.b1, static_cast<const uint8_t*>(a.w2), a.b2, a.res, a.out, a.T, a.C,
      a.k, a.dil, a.mode, a.scale, n_stages, chunks);
  return cudaGetLastError();
}

template <bool FUSED>
cudaError_t launch(const UnitArgs& a) {
  return tile_n(a.C) == 32 ? launch_unit<32, FUSED>(a) : launch_unit<64, FUSED>(a);
}

// The shape rule, set by kernels/probe_k1.py's same-call measurement of both routes (an H100, PERF.md): fuse the
// unit where C ≤ 64 (the one-conv kernel has no more tiles there; a C = 64 stage of 65,536 frames 0.53 against
// 0.61 ms), and at C = 128 where its tiles (one per 128 − (k − 1) frames of each sequence) are three for each SM
// (a stage of 32,768 frames, fused against two launches of 2-chunk blocks: B = 1 0.78 against 0.68 ms, B = 2 1.30
// against 1.38, B = 8 4.14 against 4.82).  At C = 256 a fused block holds two 256-channel tiles and has an SM to
// itself: two launches of 4-chunk blocks beat it even at B = 32 of a 4,096-frame stage (7.95 against 8.74 ms).
// Elsewhere two one-conv launches, h through device memory.
bool unit_fused(int B, int T, int C, int k, int dil) {
  const size_t stage = static_cast<size_t>(tile_n(C)) * tile_n(C) * 2;
  if (fixed_bytes(C, k, dil, true) + 2 * stage > kSmemLimit) return false;
  if (K1_BF16_ROUTE != 0) return K1_BF16_ROUTE == 1;
  const long tiles = static_cast<long>((T + BM - (k - 1) - 1) / (BM - (k - 1))) * B;
  return C <= 64 || (C <= 128 && tiles >= 3L * sm_count());
}

size_t packed_bytes(int C, int k) {
  const int n = tile_n(C), padded = (C + n - 1) / n * n;
  return static_cast<size_t>(k) * padded * padded * 2;
}

bool bad_shape(int B, int T, int C, int k, int dil) {
  return B <= 0 || T <= 0 || C <= 0 || k <= 0 || (k % 2) == 0 || k > 63 || dil <= 0;
}

}  // namespace

extern "C" {

// One convolution in bf16 mode: out = epilogue(conv_{k,dil}(round_bf16(lrelu(x))) + bias), the one-conv kernel.
// x, res, out (B, T, C) f32 channels-last; w: one conv's packed bf16 weights (ops/mrf.py::tile_k_major_bf16);
// bias (C,).  mode: 0 store, 1 add res, 2 (res + conv)·scale, 3 out += (res + conv)·scale.
int mrf_conv_bf16(const float* x, const void* w, const float* bias, const float* res, float* out,
                  int B, int T, int C, int k, int dil, int mode, float scale, void* stream_ptr) {
  if (bad_shape(B, T, C, k, dil) || mode < kStore || mode > kMeanAcc || (mode != kStore && res == nullptr))
    return cudaErrorInvalidValue;
  return launch<false>({x, w, nullptr, bias, nullptr, res, out, B, T, C, k, dil, mode, scale,
                        static_cast<cudaStream_t>(stream_ptr)});
}

// One ResBlock1 in bf16 mode over x (B, T, C) f32 channels-last, into out (B, T, C).  w1, w2: n_d packed bf16
// weight blocks each; b1, b2: (n_d, C) f32.  cur and h are (B, T, C) f32 scratch: a fused unit writes its result
// to the buffer it does not read (a tile's halo reads rows that its neighbours write), a unit of two one-conv
// launches puts its intermediate in the buffer that does not hold the running value.  accumulate = 0 writes out = rb(x)·scale, 1 adds rb(x)·scale to out.  Returns the first
// CUDA error, or 0.
int mrf_resblock_bf16(const float* x, float* out, float* cur, float* h,
                      const void* w1, const float* b1, const void* w2, const float* b2,
                      int B, int T, int C, int k, int n_d, const int* dils, int accumulate, float scale,
                      void* stream_ptr) {
  if (n_d <= 0 || bad_shape(B, T, C, k, 1)) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t wstride = packed_bytes(C, k);
  const char *w1b = static_cast<const char*>(w1), *w2b = static_cast<const char*>(w2);
  const float* src = x;  // the res-block's running value
  for (int i = 0; i < n_d; ++i) {
    if (dils[i] <= 0) return cudaErrorInvalidValue;
    const bool last = i == n_d - 1;
    const int mode = !last ? kResidual : (accumulate ? kMeanAcc : kMeanFirst);
    const float* bias1 = b1 + static_cast<size_t>(i) * C;
    const float* bias2 = b2 + static_cast<size_t>(i) * C;
    cudaError_t err;
    float* dst;
    if (unit_fused(B, T, C, k, dils[i])) {  // src → the other scratch buffer: no tile writes rows another reads
      dst = last ? out : (src == cur ? h : cur);
      err = launch<true>({src, w1b + i * wstride, w2b + i * wstride, bias1, bias2, src, dst, B, T, C, k, dils[i], mode,
                          scale, stream});
    } else {  // src → mid, then mid → src in place (an element is read and written by one thread), or out
      float* mid = src == h ? cur : h;
      dst = last ? out : (src == x ? cur : const_cast<float*>(src));
      err = launch<false>({src, w1b + i * wstride, nullptr, bias1, nullptr, nullptr, mid, B, T, C, k, dils[i], kStore,
                           1.f, stream});
      if (err != cudaSuccess) return err;
      err = launch<false>({mid, w2b + i * wstride, nullptr, bias2, nullptr, src, dst, B, T, C, k, 1, mode, scale,
                           stream});
    }
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // extern "C"
