// K3: the routed experts of a mixture-of-experts layer (DeepSeek-V2's), f32.
//
// Replaces no TPU kernel: the JAX package runs no mixture-of-experts model.
// It was added because transformers' own expert loop counts the tokens of
// each expert on the host and launches one product per expert, which cannot
// be captured in a CUDA graph, and because computing all experts for every
// token and masking would read every expert's weights at every decode step.
// For each row t of x (T, H) and its k routed experts e_j = ids[t, j] with
// weights p_j:
//
//   out[t] = sum_j p_j * W2[e_j] (silu(W1[e_j] x[t]) * W3[e_j] x[t])     (j in order)
//
// over the layer's stacked weights w13 (E, 2I, H) (gate rows, then up rows,
// of each expert) and w2 (E, H, I).  An id equal to E routes nowhere.  Every
// decision is read from device memory, so the calls can be captured and
// replayed with another routing.
//
// What bounds it on an H100.  A decode step (T = 1, k = 6) reads the six
// routed experts' weights, 3 * H * I * 4 bytes each (208 MB a layer at H =
// 2048, I = 1408), and does 2 operations per weight: memory bound, 62 us a
// layer at 3.35 TB/s.  A prefill of 512 rows routes 3072 pairs over 64
// experts and reads every expert once (2.2 GB a layer) for 53 GFLOP: in full
// f32 (TF32 is off in the configurations that run it) the CUDA cores' 67
// TFLOP/s bound it before the memory does.
//
// Design.
//   * Few pairs (a decode step): k3_gateup_gemv, one block per (pair, 8 rows
//     of I), one warp per row pair (gate row i and up row i of the pair's
//     expert) streaming both rows once in 16-byte loads that skip L1
//     (__ldcs) against the row of x in shared memory, the warp's sum by
//     shuffles, silu(gate) * up written to act (T*k, I).  k3_down_gemv, one
//     block per (row t, 8 features of H), one warp per feature: the row's k
//     activated intermediates in shared memory, the k experts' down rows
//     streamed in turn, each product weighted and added in j order, so the
//     combine costs no pass of its own.  Nothing is sorted or scheduled.
//   * Many pairs (a prefill): the pairs sorted by expert on the device
//     (order, the inverse slot, per-expert offsets and tile counts: ops/moe.py
//     builds them with torch's device sort and scans), then a grouped GEMM of
//     64 x 64 tiles, 16-deep steps, 4 x 4 outputs a thread, the next step's
//     global loads issued before the current step's products.  The grid is
//     the static worst case, ceil(T*k / 64) + E row tiles by the output
//     columns; block b finds its expert by a binary search of the tile
//     offsets and returns where b passes the routing's last tile.
//     k3_gateup_grouped gathers each pair's row of x, keeps the gate and up
//     products of one column tile side by side and writes silu(gate) * up in
//     sorted order; k3_down_grouped multiplies those rows by W2[e];
//     k3_combine adds each row's k products back, weighted, in j order.
//   * Rounding: f32 products summed in f32 in a fixed order; the weighted
//     sum with the round-to-nearest intrinsics, not contracted, as the plain
//     version's multiply then add.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 64, kBN = 64, kBK = 16, kPitch = kBM + 4;  // the pitch keeps rows 16-byte aligned
constexpr int kSmemDefault = 48 * 1024, kSmemLimit = 227 * 1024;

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// ------------------------------------------------------------------ decode: GEMVs over the routed experts

__global__ void __launch_bounds__(kThreads) k3_gateup_gemv(const float* __restrict__ x, const int* __restrict__ ids,
                                                           const float* __restrict__ w13, float* __restrict__ act,
                                                           int k, int H, int I, int E) {
  extern __shared__ float4 xs[];  // the pair's row of x, H / 4 vectors
  const int p = blockIdx.y, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int h4 = H / 4;
  const float4* row = reinterpret_cast<const float4*>(x + static_cast<size_t>(p / k) * H);
  for (int c = threadIdx.x; c < h4; c += kThreads) xs[c] = row[c];
  __syncthreads();
  if (i >= I) return;
  const int e = ids[p];
  if (e < 0 || e >= E) {
    if (lane == 0) act[static_cast<size_t>(p) * I + i] = 0.0f;
    return;
  }
  const float4* g = reinterpret_cast<const float4*>(w13 + (static_cast<size_t>(e) * 2 * I + i) * H);
  const float4* u = reinterpret_cast<const float4*>(w13 + (static_cast<size_t>(e) * 2 * I + I + i) * H);
  float ag = 0.0f, au = 0.0f;
#pragma unroll 4
  for (int c = lane; c < h4; c += 32) {
    const float4 v = xs[c];
    ag = dot4(__ldcs(g + c), v, ag);
    au = dot4(__ldcs(u + c), v, au);
  }
  ag = warp_sum(ag);
  au = warp_sum(au);
  if (lane == 0) act[static_cast<size_t>(p) * I + i] = __fmul_rn(silu(ag), au);
}

__global__ void __launch_bounds__(kThreads) k3_down_gemv(const int* __restrict__ ids, const float* __restrict__ wts,
                                                         const float* __restrict__ w2, const float* __restrict__ act,
                                                         float* __restrict__ out, int k, int H, int I, int E) {
  extern __shared__ float4 hs[];  // the row's k intermediates, k * I / 4 vectors
  const int t = blockIdx.y, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int i4 = I / 4;
  const float4* src = reinterpret_cast<const float4*>(act + static_cast<size_t>(t) * k * I);
  for (int c = threadIdx.x; c < k * i4; c += kThreads) hs[c] = src[c];
  __syncthreads();
  if (n >= H) return;
  float total = 0.0f;
  for (int j = 0; j < k; ++j) {
    const int e = ids[t * k + j];
    if (e < 0 || e >= E) continue;
    const float4* w = reinterpret_cast<const float4*>(w2 + (static_cast<size_t>(e) * H + n) * I);
    const float4* h = hs + j * i4;
    float acc = 0.0f;
#pragma unroll 4
    for (int c = lane; c < i4; c += 32) acc = dot4(__ldcs(w + c), h[c], acc);
    total = __fadd_rn(total, __fmul_rn(wts[t * k + j], warp_sum(acc)));
  }
  if (lane == 0) out[static_cast<size_t>(t) * H + n] = total;
}

// ------------------------------------------------------------------ prefill: grouped GEMM over the sorted pairs

struct Tile {
  int e, row0, rows;  // the expert, the first sorted row, the rows of the tile (e < 0: no tile)
};

// Block bx's tile: the largest e with tiles[e] <= bx (experts without a tile repeat their offset).
__device__ Tile find_tile(const int* tiles, const int* offsets, int E, int bx) {
  Tile tl{-1, 0, 0};
  if (bx >= tiles[E]) return tl;
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tiles[mid] <= bx) lo = mid; else hi = mid - 1;
  }
  tl.e = lo;
  tl.row0 = offsets[lo] + (bx - tiles[lo]) * kBM;
  tl.rows = min(kBM, offsets[lo + 1] - tl.row0);
  return tl;
}

__device__ __forceinline__ float4 load4(const float* src, int c, int K) {
  if (src == nullptr || c >= K) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return *reinterpret_cast<const float4*>(src + c);
}

__device__ __forceinline__ void stage(float (*dst)[kPitch], int r, int c, float4 v) {
  dst[c + 0][r] = v.x;
  dst[c + 1][r] = v.y;
  dst[c + 2][r] = v.z;
  dst[c + 3][r] = v.w;
}

// C[m][n] (+)= sum_k A[m][k] B[n][k] of one 16-deep step, thread (ty, tx) on rows ty*4.., columns tx*4..;
// as and each bs[b] are [kBK][kPitch] tiles in shared memory.
template <int NB>
__device__ __forceinline__ void step_products(const float* as, const float* const* bs, float (*acc)[4][4], int ty,
                                              int tx) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(as + kk * kPitch + ty * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float4 w = *reinterpret_cast<const float4*>(bs[b] + kk * kPitch + tx * 4);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[b][m][n] = fmaf(av[m], wv[n], acc[b][m][n]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) k3_gateup_grouped(const float* __restrict__ x,
                                                              const float* __restrict__ w13,
                                                              const int* __restrict__ order,
                                                              const int* __restrict__ offsets,
                                                              const int* __restrict__ tiles, float* __restrict__ act,
                                                              int k, int H, int I, int E) {
  __shared__ __align__(16) float as[kBK][kPitch];
  __shared__ __align__(16) float bg[kBK][kPitch];
  __shared__ __align__(16) float bu[kBK][kPitch];
  __shared__ Tile tl;
  const int tid = threadIdx.x;
  if (tid == 0) tl = find_tile(tiles, offsets, E, blockIdx.x);
  __syncthreads();
  if (tl.e < 0) return;
  const int n0 = blockIdx.y * kBN;
  const int lr = tid >> 2, lk = (tid & 3) * 4;  // the loader's row and 4 columns of the step
  const float* a_src = lr < tl.rows ? x + static_cast<size_t>(order[tl.row0 + lr] / k) * H : nullptr;
  const bool col = n0 + lr < I;
  const float* g_src = col ? w13 + (static_cast<size_t>(tl.e) * 2 * I + n0 + lr) * H : nullptr;
  const float* u_src = col ? w13 + (static_cast<size_t>(tl.e) * 2 * I + I + n0 + lr) * H : nullptr;
  const int ty = tid >> 4, tx = tid & 15;
  float acc[2][4][4] = {};
  const float* bs[2] = {&bg[0][0], &bu[0][0]};
  float4 a = load4(a_src, lk, H), g = load4(g_src, lk, H), u = load4(u_src, lk, H);
  for (int k0 = 0; k0 < H; k0 += kBK) {
    stage(as, lr, lk, a);
    stage(bg, lr, lk, g);
    stage(bu, lr, lk, u);
    __syncthreads();
    if (k0 + kBK < H) {
      a = load4(a_src, k0 + kBK + lk, H);
      g = load4(g_src, k0 + kBK + lk, H);
      u = load4(u_src, k0 + kBK + lk, H);
    }
    step_products<2>(&as[0][0], bs, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = ty * 4 + m;
    if (r >= tl.rows) continue;
    float* dst = act + static_cast<size_t>(tl.row0 + r) * I;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n0 + tx * 4 + n;
      if (c < I) dst[c] = __fmul_rn(silu(acc[0][m][n]), acc[1][m][n]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) k3_down_grouped(const float* __restrict__ w2,
                                                            const int* __restrict__ offsets,
                                                            const int* __restrict__ tiles,
                                                            const float* __restrict__ act, float* __restrict__ part,
                                                            int H, int I, int E) {
  __shared__ __align__(16) float as[kBK][kPitch];
  __shared__ __align__(16) float bd[kBK][kPitch];
  __shared__ Tile tl;
  const int tid = threadIdx.x;
  if (tid == 0) tl = find_tile(tiles, offsets, E, blockIdx.x);
  __syncthreads();
  if (tl.e < 0) return;
  const int n0 = blockIdx.y * kBN;
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  const float* a_src = lr < tl.rows ? act + static_cast<size_t>(tl.row0 + lr) * I : nullptr;
  const float* d_src = n0 + lr < H ? w2 + (static_cast<size_t>(tl.e) * H + n0 + lr) * I : nullptr;
  const int ty = tid >> 4, tx = tid & 15;
  float acc[1][4][4] = {};
  const float* bs[1] = {&bd[0][0]};
  float4 a = load4(a_src, lk, I), d = load4(d_src, lk, I);
  for (int k0 = 0; k0 < I; k0 += kBK) {
    stage(as, lr, lk, a);
    stage(bd, lr, lk, d);
    __syncthreads();
    if (k0 + kBK < I) {
      a = load4(a_src, k0 + kBK + lk, I);
      d = load4(d_src, k0 + kBK + lk, I);
    }
    step_products<1>(&as[0][0], bs, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = ty * 4 + m;
    if (r >= tl.rows) continue;
    float* dst = part + static_cast<size_t>(tl.row0 + r) * H;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n0 + tx * 4 + n;
      if (c < H) dst[c] = acc[0][m][n];
    }
  }
}

__global__ void __launch_bounds__(kThreads) k3_combine(const int* __restrict__ ids, const float* __restrict__ wts,
                                                       const int* __restrict__ slot, const float* __restrict__ part,
                                                       float* __restrict__ out, int k, int H, int E) {
  const int t = blockIdx.x;
  for (int n = threadIdx.x; n < H; n += kThreads) {
    float total = 0.0f;
    for (int j = 0; j < k; ++j) {
      const int q = t * k + j;
      const int e = ids[q];
      if (e < 0 || e >= E) continue;
      total = __fadd_rn(total, __fmul_rn(wts[q], part[static_cast<size_t>(slot[q]) * H + n]));
    }
    out[static_cast<size_t>(t) * H + n] = total;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  if (bytes <= static_cast<size_t>(kSmemDefault)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

bool bad_shape(int T, int k, int H, int I, int E) {
  return T <= 0 || k <= 0 || H <= 0 || I <= 0 || E <= 0 || H % 4 || I % 4;
}

}  // namespace

extern "C" {

// Few pairs: x (T, H), ids (T, k) int32, wts (T, k), w13 (E, 2I, H), w2 (E, H, I) -> act (T*k, I) scratch,
// out (T, H).  Returns the first CUDA error, or 0.
int k3_gemv(const float* x, const int* ids, const float* wts, const float* w13, const float* w2, float* act,
            float* out, int T, int k, int H, int I, int E, void* stream_ptr) {
  if (bad_shape(T, k, H, I, E) || T * k > 65535) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t xs = static_cast<size_t>(H) * sizeof(float), hs = static_cast<size_t>(k) * I * sizeof(float);
  cudaError_t err = allow_smem(k3_gateup_gemv, xs);
  if (err != cudaSuccess) return err;
  err = allow_smem(k3_down_gemv, hs);
  if (err != cudaSuccess) return err;
  k3_gateup_gemv<<<dim3((I + kWarps - 1) / kWarps, T * k), kThreads, xs, stream>>>(x, ids, w13, act, k, H, I, E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k3_down_gemv<<<dim3((H + kWarps - 1) / kWarps, T), kThreads, hs, stream>>>(ids, wts, w2, act, out, k, H, I, E);
  return cudaGetLastError();
}

// Many pairs: as k3_gemv, with the pairs sorted by expert: order (T*k) the sorted pairs, slot (T*k) each pair's
// sorted row, offsets (E + 2) the sorted rows of each expert (the last bin: routed nowhere), tiles (E + 1) the
// exclusive sum of each expert's 64-row tiles; act (T*k, I) and part (T*k, H) scratch.
int k3_grouped(const float* x, const int* ids, const float* wts, const float* w13, const float* w2, const int* order,
               const int* slot, const int* offsets, const int* tiles, float* act, float* part, float* out,
               int T, int k, int H, int I, int E, void* stream_ptr) {
  if (bad_shape(T, k, H, I, E)) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int max_tiles = (T * k + kBM - 1) / kBM + E;
  k3_gateup_grouped<<<dim3(max_tiles, (I + kBN - 1) / kBN), kThreads, 0, stream>>>(x, w13, order, offsets, tiles,
                                                                                   act, k, H, I, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k3_down_grouped<<<dim3(max_tiles, (H + kBN - 1) / kBN), kThreads, 0, stream>>>(w2, offsets, tiles, act, part, H,
                                                                                 I, E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k3_combine<<<T, kThreads, 0, stream>>>(ids, wts, slot, part, out, k, H, E);
  return cudaGetLastError();
}

const char* k3_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
