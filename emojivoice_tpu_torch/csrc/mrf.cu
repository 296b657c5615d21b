// K1: HiFi-GAN MRF res-block (ResBlock1) on Hopper, f32, CUDA-core FMA.
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
// What bounds it.  A conv is 2·k·C²·T FLOPs; one v1 stage at 512 mel frames
// is 34-135 GFLOP (C = 256, 128, 64, 32 at T = 4096 ... 131072).  Reading
// and writing the (T, C) activations once per conv gives k·C/4 FLOP per
// byte: 24 at C = 32, k = 3 (about the H100's f32 ridge of 67 TFLOP/s over
// 3.35 TB/s, ~20) and 48 to 704 elsewhere, so the stages are FMA bound
// once the taps reuse their input tile.  The TPU kernel's design — a
// (t_tile + 2·60) × C tile plus one res-block's weights resident in 12 MB
// of VMEM — does not fit 227 KB of shared memory (one res-block's weights
// are 17.3 MB at C = 256, 2.9 MB per conv at k = 11).
//
// Design.  One launch per convolution (2·len(dilations) per res-block), the
// intermediate through global memory (it stays in the 50 MB L2 at these
// sizes), weights streamed from L2.  Each conv is a tap-shifted GEMM,
// out[t, co] = Σ_j Σ_ci lrelu(x[t + (j - k/2)·d, ci]) · W[j, ci, co]:
// a block owns a BM-frame × BN-channel output tile; per BK-channel slice it
// stages lrelu(x) for the tile plus its (k/2)·d halo in shared memory ONCE,
// with zeros outside [0, T) (the per-layer zero padding), then runs all k
// taps as row-shifted reads of that one tile against each tap's BK × BN
// weight slice.  Each thread accumulates a 4 × 4 register tile in f32.
// The GEMM is SIMT FMA; wgmma/TMA and a fused dilation unit are later work.
//
// Plain C interface (built with nvcc into a shared library, bound through
// ctypes); launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;        // input channels per shared-memory slice
constexpr int TM = 4;         // output frames per thread
constexpr int TN = 4;         // output channels per thread
constexpr int THREADS = 256;
constexpr float SLOPE = 0.1f;

enum Epilogue : int {
  kStore = 0,      // out = conv
  kResidual = 1,   // out = res + conv          (res may alias out)
  kMeanFirst = 2,  // out = (res + conv) * scale
  kMeanAcc = 3,    // out += (res + conv) * scale
};

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS)
conv_taps_kernel(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                 const float* res, float* out, int T, int C, int k, int dil, int mode, float scale) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "one TM x TN tile per thread");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int halo = (k / 2) * dil;
  const int rows = BM + 2 * halo;
  float* Bs = smem;             // [BK][BN] weight slice of one tap (16-byte aligned)
  float* As = smem + BK * BN;   // [BK][rows] lrelu(x) slice, channel-major

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  constexpr int NTX = BN / TN;
  const int tx = tid % NTX;
  const int ty = tid / NTX;

  const float* xb = x + static_cast<size_t>(b) * T * C;
  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += BK) {
    for (int i = tid; i < rows * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int t = t0 - halo + r, ci = ci0 + kk;
      float v = 0.f;
      if (t >= 0 && t < T && ci < C) {
        v = xb[static_cast<size_t>(t) * C + ci];
        v = v > 0.f ? v : v * SLOPE;
      }
      As[kk * rows + r] = v;
    }
    for (int j = 0; j < k; ++j) {
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN, n = i % BN;
        const int ci = ci0 + kk, co = co0 + n;
        Bs[i] = (ci < C && co < C) ? w[(static_cast<size_t>(j) * C + ci) * C + co] : 0.f;
      }
      __syncthreads();
      const float* a_base = As + ty * TM + j * dil;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM];
#pragma unroll
        for (int m = 0; m < TM; ++m) a[m] = a_base[kk * rows + m];
        const float4 bv = reinterpret_cast<const float4*>(Bs + kk * BN)[tx];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          acc[m][0] = fmaf(a[m], bv.x, acc[m][0]);
          acc[m][1] = fmaf(a[m], bv.y, acc[m][1]);
          acc[m][2] = fmaf(a[m], bv.z, acc[m][2]);
          acc[m][3] = fmaf(a[m], bv.w, acc[m][3]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int t = t0 + ty * TM + m;
    if (t >= T) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int co = co0 + tx * TN + n;
      if (co >= C) continue;
      const size_t o = (static_cast<size_t>(b) * T + t) * C + co;
      const float v = acc[m][n] + bias[co];
      switch (mode) {
        case kStore: out[o] = v; break;
        case kResidual: out[o] = res[o] + v; break;
        case kMeanFirst: out[o] = (res[o] + v) * scale; break;
        default: out[o] += (res[o] + v) * scale; break;
      }
    }
  }
}

template <int BM, int BN>
cudaError_t launch_conv(const float* x, const float* w, const float* bias, const float* res, float* out,
                        int B, int T, int C, int k, int dil, int mode, float scale, cudaStream_t stream) {
  const int halo = (k / 2) * dil;
  const size_t smem = sizeof(float) * (static_cast<size_t>(BK) * BN + static_cast<size_t>(BK) * (BM + 2 * halo));
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((T + BM - 1) / BM, (C + BN - 1) / BN, B);
  conv_taps_kernel<BM, BN><<<grid, THREADS, smem, stream>>>(x, w, bias, res, out, T, C, k, dil, mode, scale);
  return cudaGetLastError();
}

cudaError_t conv(const float* x, const float* w, const float* bias, const float* res, float* out,
                 int B, int T, int C, int k, int dil, int mode, float scale, cudaStream_t stream) {
  // narrow stages: taller time tiles instead of half-empty channel tiles
  if (C <= 32) return launch_conv<128, 32>(x, w, bias, res, out, B, T, C, k, dil, mode, scale, stream);
  return launch_conv<64, 64>(x, w, bias, res, out, B, T, C, k, dil, mode, scale, stream);
}

}  // namespace

extern "C" {

// One ResBlock1 over x (B, T, C) f32 channels-last, into out (B, T, C).
// w1, w2: (n_d, k, C, C) as [dilation][tap][c_in][c_out]; b1, b2: (n_d, C).
// cur and h are (B, T, C) scratch.  accumulate = 0 writes out = rb(x)·scale,
// 1 adds rb(x)·scale to out.  Returns the first CUDA error, or 0.
int mrf_resblock_f32(const float* x, float* out, float* cur, float* h,
                     const float* w1, const float* b1, const float* w2, const float* b2,
                     int B, int T, int C, int k, int n_d, const int* dils, int accumulate, float scale,
                     void* stream_ptr) {
  if (B <= 0 || T <= 0 || C <= 0 || n_d <= 0 || k <= 0 || (k % 2) == 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t wstride = static_cast<size_t>(k) * C * C;
  const float* src = x;  // the res-block's running value: x, then cur
  for (int i = 0; i < n_d; ++i) {
    cudaError_t err = conv(src, w1 + i * wstride, b1 + static_cast<size_t>(i) * C, nullptr, h,
                           B, T, C, k, dils[i], kStore, 1.f, stream);
    if (err != cudaSuccess) return err;
    const bool last = i == n_d - 1;
    const int mode = !last ? kResidual : (accumulate ? kMeanAcc : kMeanFirst);
    err = conv(h, w2 + i * wstride, b2 + static_cast<size_t>(i) * C, src, last ? out : cur,
               B, T, C, k, 1, mode, scale, stream);
    if (err != cudaSuccess) return err;
    src = cur;
  }
  return cudaSuccess;
}

const char* mrf_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
