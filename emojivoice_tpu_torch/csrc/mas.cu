// K2: batched monotonic alignment search (MAS) on Hopper, f32.
//
// Replaces: emojivoice_tpu/ops/mas_pallas.py::_mas_kernel (the Pallas TPU
// kernel at mas_pallas.py:51-96, entered through maximum_path_pallas, :100).
// Given a log-prior value (B, T_x, T_y) and a mask of the same shape, it
// returns the most likely monotone path as a 0/1 tensor of that shape:
//
//   logp   = value * mask;  t_x = sum mask[:, :, 0];  t_y = sum mask[:, 0, :]
//   V[x,y] = logp[x,y] + max(V[x,y-1] (-1e9 where x == y),
//                            V[x-1,y-1] (x == 0: 0 at y == 0, else -1e9))
//   V[x,y] = -1e9 where x > y                      (set after the add)
//   D[x,y] = ((x == y) | (V[x,y-1] < V[x-1,y-1])) & (x != 0)
//   walk back from (t_x - 1, t_y - 1): mark (x, y); x -= D[x,y]
//   path  *= mask
//
// The result is the TPU kernel's to the bit: the only arithmetic is one f32
// multiply by the 0/1 mask, one f32 add and one max per cell, written with
// the round-to-nearest intrinsics so that nothing is contracted or reordered.
//
// What bounds it.  The bytes are small (value and mask read once, path
// written once: 3 * B * T_x * T_y * 4 bytes, 38 MB at 16 x 256 x 768); the
// chain is not: column y needs column y - 1, and the walk back is serial
// too, so an item costs t_y dependent steps forward and t_y backward
// whatever the memory rate.  The design spends its effort on the cost of one
// step, not on bandwidth.
//
// Design.  One thread block per batch item (grid = B, no batch padding),
// text positions x across the threads (a loop where T_x exceeds the block).
//   * The caller's layout has T_y fastest, the DP wants all x of one y.  The
//     block loads tiles of 32 mel frames: each warp reads 128 contiguous
//     bytes of one text row, multiplies by the mask and stores into a
//     (T_x, 33) shared tile (the odd pitch keeps the column reads of the DP
//     free of bank conflicts).  No transpose pass outside the kernel.
//   * The previous and the current DP column live in two shared buffers of
//     T_x floats; one __syncthreads() per mel frame.
//   * The walk back needs only D.  Each warp packs its 32 decision bits with
//     __ballot_sync into one word: T_y * ceil(T_x / 32) words, 24 KB at
//     256 x 768, kept in shared memory where the block's 227 KB allow
//     (up to 512 x 2048) and in a global scratch buffer otherwise.
//   * Columns y >= t_y are never read by the walk back, so the forward pass
//     stops at t_y: the same bits for fewer steps.
//   * One thread walks back over t_y steps, one shared-memory bit per step,
//     and records the text index of every frame; then all threads write the
//     ones (times the mask) into the output, which the block zeroed first.
//
// Plain C interface (built with nvcc into a shared library, bound through
// ctypes); launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr float kMaxNeg = -1e9f;
constexpr int kTile = 32;                 // mel frames per shared tile
constexpr int kPitch = kTile + 1;         // odd pitch: conflict-free column reads
constexpr int kMaxThreads = 1024;
constexpr size_t kSmemLimit = 232448 - 64;  // 227 KB a block can use on sm_90, less the static slot

struct Layout {
  size_t base;   // columns + tile + frame index, bytes
  size_t bits;   // decision bits, bytes
  int words;     // bit words per mel frame
  int txp;       // T_x rounded up to whole warps
};

inline Layout layout(int Tx, int Ty) {
  Layout l;
  l.txp = (Tx + 31) / 32 * 32;
  l.words = l.txp / 32;
  l.base = sizeof(float) * (2 * static_cast<size_t>(l.txp) + static_cast<size_t>(Tx) * kPitch) +
           sizeof(int) * static_cast<size_t>(Ty);
  l.bits = sizeof(unsigned) * static_cast<size_t>(Ty) * l.words;
  return l;
}

__device__ float block_sum(float v, float* slot) {
  // the addends are 0/1 mask entries, so the float sum is exact in any order
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (threadIdx.x == 0) *slot = 0.f;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicAdd(slot, v);
  __syncthreads();
  const float total = *slot;
  __syncthreads();  // every thread has read the slot before the next sum clears it
  return total;
}

__global__ void mas_kernel(const float* __restrict__ value, const float* __restrict__ mask,
                           float* __restrict__ path, unsigned* __restrict__ scratch,
                           int Tx, int Ty, int txp, int words) {
  extern __shared__ float smem[];
  __shared__ float len_slot;
  float* col0 = smem;
  float* col1 = col0 + txp;
  float* tile = col1 + txp;                                  // (Tx, kPitch)
  int* frame_x = reinterpret_cast<int*>(tile + static_cast<size_t>(Tx) * kPitch);  // (Ty,)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t item = static_cast<size_t>(b) * Tx * Ty;
  const float* v_b = value + item;
  const float* m_b = mask + item;
  float* p_b = path + item;
  unsigned* bits = scratch ? scratch + static_cast<size_t>(b) * Ty * words
                           : reinterpret_cast<unsigned*>(frame_x + Ty);

  // lengths from the mask, and the output zeroed
  float sx = 0.f, sy = 0.f;
  for (int x = tid; x < Tx; x += nthr) sx += m_b[static_cast<size_t>(x) * Ty];
  for (int y = tid; y < Ty; y += nthr) sy += m_b[y];
  const int t_x = static_cast<int>(block_sum(sx, &len_slot));
  const int t_y = static_cast<int>(block_sum(sy, &len_slot));
  for (size_t i = tid; i < static_cast<size_t>(Tx) * Ty; i += nthr) p_b[i] = 0.f;
  if (t_x <= 0 || t_y <= 0) return;  // the walk back would start nowhere: an all-zero path

  for (int x = tid; x < txp; x += nthr) col0[x] = kMaxNeg;
  float* prev = col0;
  float* cur = col1;

  // ---- forward: one column per step, decision bits kept, values dropped ----
  for (int y0 = 0; y0 < t_y; y0 += kTile) {
    // tile of logp = value * mask, read along T_y (coalesced), stored per text row
    for (int i = tid; i < Tx * kTile; i += nthr) {
      const int x = i / kTile, j = i % kTile, y = y0 + j;
      float lp = 0.f;
      if (y < Ty) lp = __fmul_rn(v_b[static_cast<size_t>(x) * Ty + y], m_b[static_cast<size_t>(x) * Ty + y]);
      tile[x * kPitch + j] = lp;
    }
    __syncthreads();
    const int steps = min(kTile, t_y - y0);
    for (int j = 0; j < steps; ++j) {
      const int y = y0 + j;
      for (int x = tid; x < txp; x += nthr) {  // whole warps: txp is a multiple of 32
        bool dec = false;
        if (x < Tx) {
          const float p = prev[x];
          const float shifted = x > 0 ? prev[x - 1] : kMaxNeg;
          dec = ((x == y) || (p < shifted)) && (x != 0);
          const float v_cur = (x == y) ? kMaxNeg : p;
          const float v_prev = (x == 0) ? (y == 0 ? 0.f : kMaxNeg) : shifted;
          const float nv = __fadd_rn(tile[x * kPitch + j], fmaxf(v_cur, v_prev));
          cur[x] = (x > y) ? kMaxNeg : nv;
        }
        const unsigned word = __ballot_sync(0xffffffffu, dec);
        if ((tid & 31) == 0) bits[static_cast<size_t>(y) * words + (x >> 5)] = word;
      }
      __syncthreads();  // column y complete; also guards the tile before its reload
      float* t = prev; prev = cur; cur = t;
    }
  }

  // ---- walk back: one thread, one bit per mel frame ----
  if (tid == 0) {
    int x = t_x - 1;
    for (int y = t_y - 1; y >= 0; --y) {
      frame_x[y] = x;
      const unsigned word = bits[static_cast<size_t>(y) * words + (x >> 5)];
      x -= static_cast<int>((word >> (x & 31)) & 1u);
    }
  }
  __syncthreads();
  for (int y = tid; y < t_y; y += nthr) {
    const size_t at = static_cast<size_t>(frame_x[y]) * Ty + y;
    p_b[at] = m_b[at];  // 1 * mask
  }
}

}  // namespace

extern "C" {

// Words of global scratch (32-bit) that one call needs for the decision bits:
// 0 where they fit in shared memory beside the columns and the tile, else
// B * T_y * ceil(T_x / 32); -1 where even the columns and the tile do not fit.
long long mas_scratch_words(int B, int Tx, int Ty) {
  if (B <= 0 || Tx <= 0 || Ty <= 0) return -1;
  const Layout l = layout(Tx, Ty);
  if (l.base > kSmemLimit) return -1;
  if (l.base + l.bits <= kSmemLimit) return 0;
  return static_cast<long long>(B) * Ty * l.words;
}

// value, mask (B, T_x, T_y) f32 contiguous -> path (B, T_x, T_y) f32, every
// element written.  scratch: mas_scratch_words(B, T_x, T_y) words, or null
// where that is 0.  Returns the first CUDA error, or 0.
int mas_path_f32(const float* value, const float* mask, float* path, unsigned* scratch,
                 int B, int Tx, int Ty, void* stream_ptr) {
  const long long need = mas_scratch_words(B, Tx, Ty);
  if (need < 0 || (need > 0 && scratch == nullptr)) return cudaErrorInvalidValue;
  const Layout l = layout(Tx, Ty);
  const size_t smem = l.base + (need == 0 ? l.bits : 0);
  cudaError_t err = cudaFuncSetAttribute(mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = l.txp < kMaxThreads ? l.txp : kMaxThreads;
  mas_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      value, mask, path, need > 0 ? scratch : nullptr, Tx, Ty, l.txp, l.words);
  return cudaGetLastError();
}

const char* mas_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
