// K1: HiFi-GAN MRF res-block (ResBlock1) on Hopper: wgmma TF32 tensor-core
// products with a 3xTF32 split, f32 accuracy.
//
// Replaces: emojivoice_tpu/ops/pallas_mrf.py::_resblock_pallas (the Pallas
// TPU kernel at pallas_mrf.py:105, body :128-148).  One call of
// mrf_resblock_f32 computes one whole res-block,
//
//   for d in dilations:  x += conv_{k,1}(lrelu_0.1(conv_{k,d}(lrelu_0.1(x))))
//
// with per-conv zero padding at the true sequence edges, and folds the
// stage's mean over res-blocks into the last conv's epilogue
// (out = x_rb / n  for the first res-block, out += x_rb / n  for the rest).
//
// What bounds it on an H100.  A conv is 2·k·C²·T FLOPs; one v1 stage at 512
// mel frames is 34-135 GFLOP (C = 256, 128, 64, 32 at T = 4096 ... 131072)
// over activations read and written once per conv: operations, not bytes.
// The f32 pipes outside the tensor cores peak at 67 TFLOP/s; the tensor
// cores do 495 TFLOP/s in TF32, but one TF32 product keeps only 10 mantissa
// bits of each operand, which over up to 11 × 256 terms lands at the edge of
// the 2e-4 tolerance.  So each f32 operand is split in two TF32 numbers,
// hi = tf32(a) and lo = tf32(a − hi), both rounded to nearest, and each tap
// product is three tensor-core products accumulated in f32,
// a_lo·w_hi + a_hi·w_lo + a_hi·w_hi (the dropped a_lo·w_lo is below 2⁻²¹ of
// the term): f32 accuracy at a bound of 3 × operations / 495 TFLOP/s.
//
// Design.  One launch per convolution (2·len(dilations) per res-block), the
// intermediate through global memory.  Each conv is a tap-shifted GEMM,
// out[t, co] = Σ_j Σ_ci lrelu(x[t + (j − k/2)·d, ci]) · W[j, ci, co], with
// M = time, N = c_out, K = c_in per tap.
//   * A block owns 64·NWG·MT frames (NWG consumer warpgroups, MT 64-row
//     subtiles each) × BN output channels, and has one more warpgroup of which
//     one warp only copies; it hands its registers to the consumers
//     (setmaxnreg), whose accumulators and fragments need about 200.  A
//     dependent wgmma chain on one accumulator advances every ~130 cycles
//     whatever its width, so the tensor cores are kept busy by independent
//     chains: two warpgroups × MT subtiles, the narrower BN the more of them.
//     Tall tiles also cut the weight traffic from L2, which is (T / frames per
//     block) × all weights per conv and was the first limit.
//   * Blocks are persistent (one per SM, walking over tiles): the copying warp
//     runs ahead into the next tile while the consumers store the current one.
//   * Per slice of KC = 32 input channels the raw x tile plus its (k/2)·d halo
//     is staged ONCE by tensor copies (TMA) of 64 frames × 32 channels from a
//     3-D map of x (channels, frames, batch): what a box holds outside the
//     tensor arrives as zeros, which is the conv's zero padding at the true
//     edges and the padding of C to 32.  Every tap reads the tile shifted by
//     (j − k/2)·d rows.
//   * A comes from registers (the RS form of wgmma): each thread loads its
//     m64k8 fragment with ordinary shared-memory loads, so any row shift is
//     legal; lrelu, the rounding and the hi/lo split happen there, once per
//     fragment for all three products.  Rows are 128 bytes in the TMA's
//     128-byte swizzle (16-byte group g of row r lies at g ^ (r % 8)), which
//     keeps the fragment loads free of bank conflicts without a padded pitch.
//   * B comes from shared memory through a descriptor.  TF32 wgmma takes B
//     K-major only, so the weights are packed once outside the kernel: c_in
//     fastest, split in w_hi and w_lo (TF32 rounded), and tiled in the order
//     the kernel consumes them, [c_in slice][tap][hi, lo][4-c_in group][c_out][4].
//     That is the no-swizzle core-matrix layout of the descriptor (8 c_out
//     rows × 16 bytes are 128 contiguous bytes, SBO = 128; the next 4 c_in lie
//     BN·16 bytes on, LBO), so one (slice, tap) stage of the ring arrives by
//     one or a few bulk copies (cp.async.bulk, completion on an mbarrier)
//     started by one thread: the consumers never stall on starting copies.
//   * Rings with full/empty mbarriers: up to 6 weight stages and 2 x slices in
//     flight; the warpgroups run free of each other, no block barrier in the
//     main loop.
//   * Epilogue from the accumulator fragment with the bias in f32, in the four
//     modes below; frames beyond T and channels beyond C are masked.
// C that is no multiple of 8 is zero-padded in shared memory and in the tiled
// weights, never in the activations in global memory; C that is no multiple
// of 4 (rows not 16-byte aligned) takes scalar copies of x instead of TMA.
//
// K1's bf16 mode (mrf_resblock_bf16, mrf_conv_bf16) is a kernel of its own,
// csrc/mrf_bf16.cu; the primitives and the epilogue modes both use are in
// csrc/k1_common.cuh.
//
// Plain C interface (built with nvcc into a shared library, bound through
// ctypes); launches on the caller's stream and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>
#include <cstring>

#include "k1_common.cuh"

// -DK1_PHASE_CLOCKS: one consumer thread of block 0 sums clock64() cycles per phase (waiting for x, waiting for
// weights, loading and splitting fragments, products in flight, epilogue) and prints them when the block ends.
// No profiler runs on every machine with a card; kernels/probe_k1.py builds this variant.
#ifdef K1_PHASE_CLOCKS
#include <cstdio>
#define K1_TIC() k1_c = clock64()
#define K1_TOC(phase) k1_t[phase] += clock64() - k1_c
#else
#define K1_TIC()
#define K1_TOC(phase)
#endif

namespace {

enum Phase : int { kWaitX = 0, kWaitW, kFragments, kProducts, kEpilogue, kPhases };

constexpr int KC = 32;            // input channels per staged slice: four k8 TF32 steps
constexpr int KSTEPS = KC / 8;    // wgmma k8 steps per slice
constexpr int W_GROUPS = 2 * (KC / 4);  // 16-byte groups per c_out row of one (slice, tap) weight stage: hi and lo

// one box of a 3-D tensor map (x: channels, frames, batch) into shared memory; the barrier counts its bytes
__device__ __forceinline__ void tensor_copy_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// f32 → the nearest TF32 number, ties away from zero (what cvt.rna.tf32.f32 gives, and the packer's rule for the
// weights), by integer arithmetic on the bit pattern: conversions run at a fraction of the integer rate
__device__ __forceinline__ uint32_t round_tf32(float v) { return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u; }

// d (64 × N, f32, in registers) += a (64 × 8 TF32, registers) · b (8 × N TF32, shared memory, K-major)
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : K1_D16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : K1_D16(0), K1_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : K1_D16(0), K1_D16(16), K1_D16(32), K1_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

constexpr int kMaxStages = 6;   // weight ring depth, at most
constexpr int kBarBytes = 1024;  // the mbarriers, and the x ring behind them aligned for the 128-byte swizzle
constexpr int ABOX = 64;         // rows of x per tensor copy

// rows of one x buffer: the tile, its halo, rounded up to whole copies
__host__ __device__ constexpr int a_rows(int bm, int halo) { return (bm + 2 * halo + ABOX - 1) / ABOX * ABOX; }

// One instantiation: BN output channels (one wgmma tile wide), NWG consumer
// warpgroups of MT 64-row subtiles, KG k-steps per wgmma commit group (three
// TF32 products per k8 step).  The blocks are persistent: each walks over
// tiles blockIdx.x, + gridDim.x, ..., the copying warp running ahead into the next tile while
// the consumers finish and store the current one.
template <int BN, int NWG, int MT, int KG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
conv_taps_kernel(const __grid_constant__ CUtensorMap x_map, const float* __restrict__ x,
                 const void* __restrict__ w, const float* __restrict__ bias, const float* res, float* out,
                 int B, int T, int C, int k, int dil, int mode, float scale, int n_stages) {
  constexpr int BM = 64 * NWG * MT;
  constexpr int STAGE_BYTES = W_GROUPS * BN * 16;  // one tap's [W_GROUPS][BN][16 bytes] slice
  static_assert(KSTEPS % KG == 0, "whole commit groups per channel slice");
  extern __shared__ __align__(1024) float4 smem4[];
  const int halo = (k / 2) * dil;
  const int rows = a_rows(BM, halo);
  // mbarriers at the front: full_w[6], empty_w[6], full_a[2], empty_a[2]; then x [2][rows][KC], swizzled; then weights
  float* a_ring = reinterpret_cast<float*>(smem4) + kBarBytes / 4;
  char* w_ring = reinterpret_cast<char*>(a_ring + 2 * static_cast<size_t>(rows) * KC);  // [n_stages][STAGE_BYTES]
  const char* w_bytes = static_cast<const char*>(w);
  const uint32_t bar0 = smem_u32(smem4);
  auto full_w = [&](int s) { return bar0 + 8u * s; };
  auto empty_w = [&](int s) { return bar0 + 8u * (kMaxStages + s); };
  auto full_a = [&](int s) { return bar0 + 8u * (2 * kMaxStages + s); };
  auto empty_a = [&](int s) { return bar0 + 8u * (2 * kMaxStages + 2 + s); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool vec = (C & 3) == 0;  // tensor copies need 16-byte aligned rows
  const int n_chunks = (C + KC - 1) / KC;
  const int nbx = (T + BM - 1) / BM, nby = (C + BN - 1) / BN;
  const int n_tiles = nbx * nby * B;

  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(full_w(s), 1);
      mbar_init(empty_w(s), 4 * NWG);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_a(s), 1);
      mbar_init(empty_a(s), 4 * NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ---- the copying warpgroup: it gives its registers to the consumers, and one warp of it works ----
    if (NWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp > 4 * NWG) return;
    int slot = 0, w_round = 0, a_count = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int t0 = (tile % nbx) * BM, co0 = ((tile / nbx) % nby) * BN, bz = tile / (nbx * nby);
      const int bn_valid = min(BN, C - co0);  // output channels of this tile that exist
      for (int c = 0; c < n_chunks; ++c) {
        // x's next channel slice: rows t0 − halo ... of KC channels, zeros outside [0, T) and beyond C
        const int buf = a_count & 1;
        if (a_count >= 2) mbar_wait(empty_a(buf), ((a_count >> 1) - 1) & 1);
        float* as = a_ring + static_cast<size_t>(buf) * rows * KC;
        if (vec) {
          if (lane == 0) {
            mbar_arrive_expect_tx(full_a(buf), static_cast<uint32_t>(rows) * KC * 4u);
            for (int r = 0; r < rows; r += ABOX)
              tensor_copy_3d(smem_u32(as + r * KC), &x_map, c * KC, t0 - halo + r, bz, full_a(buf));
          }
        } else {
          const float* xb = x + static_cast<size_t>(bz) * T * C;
          for (int i = lane; i < rows * KC; i += 32) {
            const int r = i / KC, cc = i - r * KC;
            const int t = t0 - halo + r, ci = c * KC + cc;
            as[r * KC + ((((cc >> 2) ^ (r & 7)) << 2) | (cc & 3))] =
                (t >= 0 && t < T && ci < C) ? xb[static_cast<size_t>(t) * C + ci] : 0.f;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(full_a(buf));
        }
        ++a_count;
        for (int j = 0; j < k; ++j) {
          if (w_round > 0) mbar_wait(empty_w(slot), (w_round - 1) & 1);
          if (lane == 0) {
            // tiled weights: [slice][tap][W_GROUPS][C][16 bytes] ([hi, lo][KC/4][C][4] floats); this tile's c_out
            // rows are BN·16 bytes apart in the ring
            const char* src = w_bytes + ((static_cast<size_t>(c) * k + j) * W_GROUPS * C + co0) * 16;
            const uint32_t dst = smem_u32(w_ring + static_cast<size_t>(slot) * STAGE_BYTES);
            if (BN == C) {
              mbar_arrive_expect_tx(full_w(slot), STAGE_BYTES);
              bulk_copy(dst, src, STAGE_BYTES, full_w(slot));
            } else {  // rows beyond bn_valid keep what they held: they feed only columns that are never stored
              mbar_arrive_expect_tx(full_w(slot), W_GROUPS * bn_valid * 16u);
              for (int pq = 0; pq < W_GROUPS; ++pq)
                bulk_copy(dst + pq * BN * 16u, src + static_cast<size_t>(pq) * C * 16, bn_valid * 16u, full_w(slot));
            }
          }
          if (++slot == n_stages) { slot = 0; ++w_round; }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  if (NWG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");  // a block of 256 threads has them already
  const int wg = warp >> 2;
  // this thread's rows and columns of the m64k8 A fragment (the mma m16n8k8 layout, one 16-row slab per warp)
  const int frag_row = wg * MT * 64 + (warp & 3) * 16 + (lane >> 2);
  const int frag_col = lane & 3;
  const bool pair = (C & 1) == 0;
  int slot = 0, w_round = 0, a_count = 0;
#ifdef K1_PHASE_CLOCKS
  long long k1_c = 0, k1_t[kPhases] = {}, k1_start = clock64();
#endif

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int t0 = (tile % nbx) * BM, co0 = ((tile / nbx) % nby) * BN, bz = tile / (nbx * nby);
    const size_t batch_off = static_cast<size_t>(bz) * T * C;
    float acc[MT][BN / 2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;

    for (int c = 0; c < n_chunks; ++c) {
      const int buf = a_count & 1;
      K1_TIC();
      mbar_wait(full_a(buf), (a_count >> 1) & 1);
      K1_TOC(kWaitX);
      const int kw = KC / KSTEPS;  // input channels per k-step
      const int nks = min(KSTEPS, (C - c * KC + kw - 1) / kw);  // k-steps that hold a real channel
      for (int j = 0; j < k; ++j) {
        K1_TIC();
        mbar_wait(full_w(slot), w_round & 1);
        K1_TOC(kWaitW);
        // row r of the x buffer keeps its 16-byte group g at group g ^ (r % 8): the 128-byte swizzle, which
        // lets rows of 128 bytes be read by fragment without bank conflicts; 64·m + 8·h leave r % 8 alone
        const int row = frag_row + j * dil;
        const int sw = row & 7;
        const float* ap = a_ring + (static_cast<size_t>(buf) * rows + row) * KC + frag_col;
        const uint32_t ws = smem_u32(w_ring + static_cast<size_t>(slot) * STAGE_BYTES);

#pragma unroll
        for (int kg = 0; kg < KSTEPS / KG; ++kg) {
          if (kg * KG < nks) {
            K1_TIC();
            uint32_t hi[MT][KG][4], lo[MT][KG][4];
#pragma unroll
            for (int g = 0; g < KG; ++g) {
              const int g0 = ((2 * (kg * KG + g)) ^ sw) << 2, g1 = ((2 * (kg * KG + g) + 1) ^ sw) << 2;
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                const float* p = ap + m * 64 * KC;
                const float v[4] = {p[g0], p[8 * KC + g0], p[g1], p[8 * KC + g1]};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float a = v[e] > 0.f ? v[e] : v[e] * SLOPE;
                  hi[m][g][e] = round_tf32(a);
                  lo[m][g][e] = round_tf32(a - __uint_as_float(hi[m][g][e]));
                  // complete in its register before the first asynchronous product reads it
                  asm volatile("" : "+r"(hi[m][g][e]), "+r"(lo[m][g][e])::"memory");
                }
              }
            }
            K1_TOC(kFragments);
            K1_TIC();
            wgmma_fence();
#pragma unroll
            for (int g = 0; g < KG; ++g) {
              if (kg * KG + g < nks) {
                const uint32_t b_hi = ws + 16u * (2 * (kg * KG + g) * BN);
                const uint64_t d_hi = make_desc(b_hi, 16u * BN, 128u);
                const uint64_t d_lo = make_desc(b_hi + 16u * (KC / 4) * BN, 16u * BN, 128u);
                // the subtiles' chains are independent: interleaved, they hide each other's latency
#pragma unroll
                for (int m = 0; m < MT; ++m) wgmma_tf32<BN>(acc[m], lo[m][g], d_hi);
#pragma unroll
                for (int m = 0; m < MT; ++m) wgmma_tf32<BN>(acc[m], hi[m][g], d_lo);
#pragma unroll
                for (int m = 0; m < MT; ++m) wgmma_tf32<BN>(acc[m], hi[m][g], d_hi);
              }
            }
            wgmma_commit();
            wgmma_wait<0>();  // before the fragments' registers are reused and, after the last tap, the accumulators read
            K1_TOC(kProducts);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_w(slot));
        if (++slot == n_stages) { slot = 0; ++w_round; }
      }
      if (lane == 0) mbar_arrive(empty_a(buf));
      ++a_count;
    }

    // accumulator fragment: thread holds rows r, r + 8 and columns 8·i + 2·(lane % 4), + 1 of each 8-column group
    K1_TIC();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int co = co0 + 8 * i + 2 * frag_col;
        if (co >= C) continue;
        const bool two = co + 1 < C;
        const float bias0 = bias[co], bias1 = two ? bias[co + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + frag_row + m * 64 + 8 * h;
          if (t >= T) continue;
          const size_t o = batch_off + static_cast<size_t>(t) * C + co;
          float v0 = acc[m][4 * i + 2 * h] + bias0, v1 = acc[m][4 * i + 2 * h + 1] + bias1;
          if (pair) {  // C even: co is even, so the pair is 8-byte aligned and both columns exist
            if (mode != kStore) {
              const float2 r = *reinterpret_cast<const float2*>(res + o);
              v0 += r.x;
              v1 += r.y;
            }
            if (mode >= kMeanFirst) { v0 *= scale; v1 *= scale; }
            if (mode == kMeanAcc) {
              const float2 p = *reinterpret_cast<const float2*>(out + o);
              v0 += p.x;
              v1 += p.y;
            }
            *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
          } else {
            if (mode != kStore) { v0 += res[o]; if (two) v1 += res[o + 1]; }
            if (mode >= kMeanFirst) { v0 *= scale; v1 *= scale; }
            if (mode == kMeanAcc) { v0 += out[o]; if (two) v1 += out[o + 1]; }
            out[o] = v0;
            if (two) out[o + 1] = v1;
          }
        }
      }
    }
    K1_TOC(kEpilogue);
  }
#ifdef K1_PHASE_CLOCKS
  if (blockIdx.x == 0 && tid == 0)
    printf("K1 phases, block 0 thread 0, %s BN=%d NWG=%d MT=%d, %d tiles of %d, %d weight stages: wait_x %lld wait_w %lld "
           "fragments %lld products %lld epilogue %lld of %lld cycles\n", "3xTF32", BN, NWG, MT,
           (n_tiles + gridDim.x - 1) / gridDim.x,
           n_tiles, n_stages, k1_t[kWaitX], k1_t[kWaitW], k1_t[kFragments], k1_t[kProducts], k1_t[kEpilogue],
           clock64() - k1_start);
#endif
}

struct ConvArgs {
  const float* x;
  const void* w;  // tiled weights: TF32 parts
  const float *bias, *res;
  float* out;
  int B, T, C, k, dil, mode;
  float scale;
  cudaStream_t stream;
};

// cuTensorMapEncodeTiled, looked up in libcuda at first use: nothing links against it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// x (B, T, C) as a tensor of boxes KC channels × ABOX frames, 128-byte
// swizzled in shared memory; what a box holds outside the tensor is zero:
// the conv's padding in time, and the channels beyond C.
cudaError_t make_x_map(CUtensorMap* map, const ConvArgs& a) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.C), static_cast<cuuint64_t>(a.T), static_cast<cuuint64_t>(a.B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(a.C) * 4, static_cast<cuuint64_t>(a.T) * a.C * 4};
  const cuuint32_t box[3] = {KC, ABOX, 1}, elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(a.x), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, int NWG, int MT, int KG>
cudaError_t launch_conv(const ConvArgs& a) {
  constexpr int BM = 64 * NWG * MT;
  const size_t a_bytes = sizeof(float) * 2 * a_rows(BM, (a.k / 2) * a.dil) * KC;
  const size_t stage_bytes = static_cast<size_t>(W_GROUPS) * BN * 16;
  if (kBarBytes + a_bytes + 2 * stage_bytes > kSmemLimit) return cudaErrorInvalidValue;
  const int n_stages = static_cast<int>(std::min<size_t>(kMaxStages, (kSmemLimit - kBarBytes - a_bytes) / stage_bytes));
  const size_t smem = kBarBytes + a_bytes + n_stages * stage_bytes;
  CUtensorMap x_map;
  if ((a.C & 3) == 0) {
    const cudaError_t err = make_x_map(&x_map, a);
    if (err != cudaSuccess) return err;
  } else {
    memset(&x_map, 0, sizeof(x_map));  // rows that are not 16-byte aligned take the scalar copies
  }
  auto kernel = conv_taps_kernel<BN, NWG, MT, KG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long tiles = static_cast<long>((a.T + BM - 1) / BM) * ((a.C + BN - 1) / BN) * a.B;
  const int grid = static_cast<int>(std::min<long>(tiles, sm_count()));
  kernel<<<grid, 128 * (NWG + 1), smem, a.stream>>>(x_map, a.x, a.w, a.bias, a.res, a.out, a.B, a.T, a.C, a.k, a.dil,
                                                    a.mode, a.scale, n_stages);
  return cudaGetLastError();
}

// Tile choice: the narrowest channel tile that covers C (128 at most), and
// the tallest block that still gives three quarters of the card's SMs a tile.
template <int BN, int MT, int KG>
cudaError_t conv_bn(const ConvArgs& a) {
  const long enough = 3L * sm_count() / 4;
  auto tiles = [&](int bm) { return static_cast<long>((a.T + bm - 1) / bm) * ((a.C + BN - 1) / BN) * a.B; };
  if (tiles(128 * MT) >= enough) return launch_conv<BN, 2, MT, (KG < KSTEPS ? KG : KSTEPS)>(a);
  if (tiles(128) >= enough) return launch_conv<BN, 2, 1, KSTEPS>(a);
  return launch_conv<BN, 1, 1, KSTEPS>(a);
}

cudaError_t conv(const ConvArgs& a) {
  if (a.C <= 32) return conv_bn<32, 4, 2>(a);
  if (a.C <= 64) return conv_bn<64, 4, 1>(a);
  return conv_bn<128, 2, 2>(a);
}

int conv_checked(const ConvArgs& a) {
  if (a.B <= 0 || a.T <= 0 || a.C <= 0 || a.k <= 0 || (a.k % 2) == 0 || a.dil <= 0 || a.mode < kStore ||
      a.mode > kMeanAcc || (a.mode != kStore && a.res == nullptr))
    return cudaErrorInvalidValue;
  return conv(a);
}

// bytes of one convolution's tiled weights: [ceil(C/32)][k][W_GROUPS][C][16 bytes]
size_t tiled_weight_bytes(int C, int k) {
  return static_cast<size_t>((C + KC - 1) / KC) * k * W_GROUPS * C * 16;
}

int resblock(const float* x, float* out, float* cur, float* h, const void* w1, const float* b1, const void* w2,
             const float* b2, int B, int T, int C, int k, int n_d, const int* dils, int accumulate, float scale,
             void* stream_ptr) {
  if (B <= 0 || T <= 0 || C <= 0 || n_d <= 0 || k <= 0 || (k % 2) == 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t wstride = tiled_weight_bytes(C, k);
  const char *w1b = static_cast<const char*>(w1), *w2b = static_cast<const char*>(w2);
  const float* src = x;  // the res-block's running value: x, then cur
  for (int i = 0; i < n_d; ++i) {
    if (dils[i] <= 0) return cudaErrorInvalidValue;
    cudaError_t err = conv({src, w1b + i * wstride, b1 + static_cast<size_t>(i) * C, nullptr, h,
                                  B, T, C, k, dils[i], kStore, 1.f, stream});
    if (err != cudaSuccess) return err;
    const bool last = i == n_d - 1;
    const int mode = !last ? kResidual : (accumulate ? kMeanAcc : kMeanFirst);
    err = conv({h, w2b + i * wstride, b2 + static_cast<size_t>(i) * C, src, last ? out : cur,
                      B, T, C, k, 1, mode, scale, stream});
    if (err != cudaSuccess) return err;
    src = cur;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of one convolution's tiled TF32 weights: [ceil(C/32)][k][2][8][C][4].
long long mrf_tiled_weight_floats(int C, int k) {
  return static_cast<long long>(tiled_weight_bytes(C, k) / 4);
}

// One convolution of the res-block: out = epilogue(conv_{k,dil}(lrelu(x)) + bias).
// x, res, out (B, T, C) f32 channels-last; w: the tiled TF32 parts of the
// weights, mrf_tiled_weight_floats(C, k) floats; bias (C,).  mode: 0 store,
// 1 add res, 2 (res + conv)·scale, 3 out += (res + conv)·scale.
int mrf_conv_f32(const float* x, const float* w, const float* bias, const float* res, float* out,
                 int B, int T, int C, int k, int dil, int mode, float scale, void* stream_ptr) {
  return conv_checked({x, w, bias, res, out, B, T, C, k, dil, mode, scale, static_cast<cudaStream_t>(stream_ptr)});
}

// One ResBlock1 over x (B, T, C) f32 channels-last, into out (B, T, C).
// w1, w2: n_d tiled weight blocks of mrf_tiled_weight_floats(C, k) floats
// each; b1, b2: (n_d, C).  cur and h are (B, T, C) scratch.  accumulate = 0
// writes out = rb(x)·scale, 1 adds rb(x)·scale to out.  Returns the first
// CUDA error, or 0.
int mrf_resblock_f32(const float* x, float* out, float* cur, float* h,
                     const float* w1, const float* b1, const float* w2, const float* b2,
                     int B, int T, int C, int k, int n_d, const int* dils, int accumulate, float scale,
                     void* stream_ptr) {
  return resblock(x, out, cur, h, w1, b1, w2, b2, B, T, C, k, n_d, dils, accumulate, scale, stream_ptr);
}

}  // extern "C"
