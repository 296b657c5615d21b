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
// What bounds it on an H100.  The bytes are small (value and mask read once,
// path written once: 3 * B * T_x * T_y * 4 bytes, 38 MB at 16 x 256 x 768);
// the chain is not: column y needs column y - 1, and the walk back is serial
// too, so an item costs t_y dependent steps forward and t_y backward whatever
// the memory rate.  The design spends its effort on the cost of one step.
//
// Design.  One thread block of 16 warps per batch item (grid = B).
//   * One warp owns the DP column, in registers: lane l holds the R
//     consecutive text positions l*R ... l*R + R - 1 (R = 1 ... 64 by template,
//     T_x up to 2048).  A mel frame's step is R independent updates per lane
//     from the previous frame's registers and one __shfl_up_sync for the
//     neighbour lane's last position.  No block barrier and no shared-memory
//     round trip of the column per frame.  Once y has passed every x the
//     diagonal tests drop out of the step.
//   * The other 15 warps stage tiles of logp = value * mask (32 mel frames,
//     fewer where R > 8) into a ring of two or three shared tiles: 16-byte
//     loads along T_y where T_y is a multiple of 4, stored so that the
//     column warp reads lane-contiguous words ([frame][position in lane][lane],
//     the frame pitch odd, rows handed to the lanes of a loading warp R apart:
//     free of bank conflicts both ways).  The two sides meet once per tile on
//     named barriers (full / empty per ring slot), not once per frame.
//   * The walk back needs only D.  A lane packs its R decision bits per frame
//     into max(R, 8) bits; T_y * 4 * max(R, 8) bytes, kept in shared memory
//     where the block's 227 KB allow and in a global scratch buffer otherwise.
//   * Columns y >= t_y are never read by the walk back, so the forward pass
//     stops at t_y: the same bits for fewer steps.
//   * One thread walks back over t_y steps, one bit per step, and records the
//     text index of every frame; then all threads write the ones (times the
//     mask) into the output, which the block zeroed first.
//
// Plain C interface (built with nvcc into a shared library, bound through
// ctypes); launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float kMaxNeg = -1e9f;
constexpr int kWarps = 16;                  // one column warp and 15 loading warps
constexpr int kThreads = 32 * kWarps;
constexpr int kLoaders = kWarps - 1;
constexpr int kMaxR = 64;                   // text positions per lane: T_x up to 2048
constexpr unsigned kFullMask = 0xffffffffu;
constexpr size_t kSmemLimit = 232448 - 64;  // 227 KB a block can use on sm_90, less the static slot

__host__ __device__ constexpr int tile_frames(int R) { return R <= 8 ? 32 : 256 / R; }
__host__ __device__ constexpr int bit_words(int R) { return R < 8 ? 8 : R; }  // 32-bit words of decision bits per mel frame

inline int lane_positions(int Tx) {
  int r = 1;
  while (32 * r < Tx) r *= 2;
  return r;
}

struct Layout {
  int R;          // text positions per lane
  size_t tile;    // one ring tile, bytes
  size_t frames;  // frame index, bytes
  size_t bits;    // decision bits, bytes
};

inline Layout layout(int Tx, int Ty) {
  Layout l;
  l.R = lane_positions(Tx);
  l.tile = sizeof(float) * tile_frames(l.R) * (32 * static_cast<size_t>(l.R) + 1);
  l.frames = sizeof(int) * static_cast<size_t>(Ty);
  l.bits = sizeof(unsigned) * static_cast<size_t>(Ty) * bit_words(l.R);
  return l;
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ float block_sum(float v, float* slot) {
  // the addends are 0/1 mask entries, so the float sum is exact in any order
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  if (threadIdx.x == 0) *slot = 0.f;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicAdd(slot, v);
  __syncthreads();
  const float total = *slot;
  __syncthreads();  // every thread has read the slot before the next sum clears it
  return total;
}

// One mel frame for the lane's R positions, in place: p[i] is V[lane*R + i, y - 1]
// on entry and V[., y] on return; w receives the decision bits.  DIAG = false
// is the step for y >= 32*R, where x == y and x > y cannot hold.
template <int R, bool DIAG>
__device__ __forceinline__ void frame_step(float (&p)[R], const float* __restrict__ tp, int y, int lane,
                                           unsigned (&w)[(R + 31) / 32]) {
  const float up = __shfl_up_sync(kFullMask, p[R - 1], 1);  // V[lane*R - 1, y - 1]
#pragma unroll
  for (int c = 0; c < (R + 31) / 32; ++c) w[c] = 0u;
#pragma unroll
  for (int i = R - 1; i >= 0; --i) {  // downwards: p[i - 1] is still the previous frame's
    const int x = lane * R + i;
    const float cur = p[i];
    float shifted = i > 0 ? p[i - 1] : up;
    const float lp = tp[i * 32];
    bool dec;
    float nv;
    if (DIAG) {
      const bool first = x == 0;
      dec = ((x == y) || (cur < shifted)) && !first;
      const float v_cur = (x == y) ? kMaxNeg : cur;
      const float v_prev = first ? (y == 0 ? 0.f : kMaxNeg) : shifted;
      nv = __fadd_rn(lp, fmaxf(v_cur, v_prev));
      nv = (x > y) ? kMaxNeg : nv;
    } else {
      if (i == 0 && lane == 0) shifted = kMaxNeg;  // x == 0 has no row above it
      dec = cur < shifted;
      nv = __fadd_rn(lp, fmaxf(cur, shifted));
    }
    p[i] = nv;
    w[i / 32] |= static_cast<unsigned>(dec) << (i % 32);
  }
  if (!DIAG && lane == 0) w[0] &= ~1u;  // D is 0 at x == 0
}

template <int R>
__device__ __forceinline__ void store_bits(unsigned* bits, int y, int lane, const unsigned (&w)[(R + 31) / 32]) {
  if (R <= 8) {
    reinterpret_cast<uint8_t*>(bits)[y * 32 + lane] = static_cast<uint8_t>(w[0]);
  } else if (R == 16) {
    reinterpret_cast<uint16_t*>(bits)[y * 32 + lane] = static_cast<uint16_t>(w[0]);
  } else {
#pragma unroll
    for (int c = 0; c < (R + 31) / 32; ++c) bits[(static_cast<size_t>(y) * 32 + lane) * (R / 32) + c] = w[c];
  }
}

template <int R>
__device__ __forceinline__ int load_bit(const unsigned* bits, int y, int x) {
  const int lane = x / R, i = x % R;
  if (R <= 8) return (reinterpret_cast<const uint8_t*>(bits)[y * 32 + lane] >> i) & 1;
  if (R == 16) return (reinterpret_cast<const uint16_t*>(bits)[y * 32 + lane] >> i) & 1;
  return (bits[(static_cast<size_t>(y) * 32 + lane) * (R / 32) + i / 32] >> (i % 32)) & 1u;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
mas_kernel(const float* __restrict__ value, const float* __restrict__ mask, float* __restrict__ path,
           unsigned* __restrict__ scratch, int Tx, int Ty, int n_slots, int vec) {
  constexpr int TF = tile_frames(R);     // mel frames per tile
  constexpr int PJ = 32 * R + 1;         // floats between frames of a tile: odd
  constexpr int BW = bit_words(R);
  extern __shared__ float smem[];
  __shared__ float len_slot;
  float* tiles = smem;                                                   // [n_slots][TF][PJ]
  int* frame_x = reinterpret_cast<int*>(tiles + static_cast<size_t>(n_slots) * TF * PJ);  // (Ty,)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t item = static_cast<size_t>(b) * Tx * Ty;
  const float* v_b = value + item;
  const float* m_b = mask + item;
  float* p_b = path + item;
  unsigned* bits = scratch ? scratch + static_cast<size_t>(b) * Ty * BW
                           : reinterpret_cast<unsigned*>(frame_x + Ty);

  // lengths from the mask, and the output zeroed
  float sx = 0.f, sy = 0.f;
  for (int x = tid; x < Tx; x += kThreads) sx += m_b[static_cast<size_t>(x) * Ty];
  for (int y = tid; y < Ty; y += kThreads) sy += m_b[y];
  const int t_x = static_cast<int>(block_sum(sx, &len_slot));
  const int t_y = static_cast<int>(block_sum(sy, &len_slot));
  if (vec) {  // T_y a multiple of 4 and the base 16-byte aligned: every item is
    float4* p4 = reinterpret_cast<float4*>(p_b);
    for (size_t i = tid; i < static_cast<size_t>(Tx) * Ty / 4; i += kThreads) p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (size_t i = tid; i < static_cast<size_t>(Tx) * Ty; i += kThreads) p_b[i] = 0.f;
  }
  if (t_x <= 0 || t_y <= 0) return;  // the walk back would start nowhere: an all-zero path

  const int n_tiles = (t_y + TF - 1) / TF;
  const int full0 = 1, empty0 = 1 + n_slots;  // named barriers; 0 is __syncthreads()

  if (warp > 0) {
    // ---- loading warps: logp = value * mask, TF frames at a time, into the ring ----
    const int E = vec ? 4 : 1;         // frames per lane: one 16-byte load, or one float
    const int QF = TF / E;             // lanes along a row's TF frames
    const int RPW = 32 / QF;           // rows per warp pass, R text positions apart
    const int q = lane % QF, rr = lane / QF;
    const int units = QF * R;
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % n_slots;
      if (n >= n_slots) bar_sync(empty0 + s, kThreads);  // the column warp is done with tile n - n_slots
      float* tile = tiles + static_cast<size_t>(s) * TF * PJ;
      const int y = n * TF + q * E;
#pragma unroll 4
      for (int u = warp - 1; u < units; u += kLoaders) {
        const int i = u % R, l = (u / R) * RPW + rr;
        const int x = l * R + i;
        float* dst = tile + (q * E) * PJ + i * 32 + l;
        const size_t at = static_cast<size_t>(x) * Ty + y;
        if (vec) {
          float4 lp = make_float4(0.f, 0.f, 0.f, 0.f);
          if (x < Tx && y < Ty) {  // T_y is a multiple of 4 here: the four frames are in or out together
            const float4 v = *reinterpret_cast<const float4*>(v_b + at);
            const float4 m = *reinterpret_cast<const float4*>(m_b + at);
            lp = make_float4(__fmul_rn(v.x, m.x), __fmul_rn(v.y, m.y), __fmul_rn(v.z, m.z), __fmul_rn(v.w, m.w));
          }
          dst[0] = lp.x;
          dst[PJ] = lp.y;
          dst[2 * PJ] = lp.z;
          dst[3 * PJ] = lp.w;
        } else {
          dst[0] = (x < Tx && y < Ty) ? __fmul_rn(v_b[at], m_b[at]) : 0.f;
        }
      }
      bar_arrive(full0 + s, kThreads);
    }
  } else {
    // ---- column warp: one mel frame per step, decision bits kept, values dropped ----
    float p[R];
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = kMaxNeg;
    unsigned w[(R + 31) / 32];
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % n_slots;
      bar_sync(full0 + s, kThreads);
      const float* tp = tiles + static_cast<size_t>(s) * TF * PJ + lane;
      const int steps = min(TF, t_y - n * TF);
      int j = 0;
      for (; j < steps && n * TF + j < 32 * R; ++j) {  // frames that can still meet the diagonal
        frame_step<R, true>(p, tp + j * PJ, n * TF + j, lane, w);
        store_bits<R>(bits, n * TF + j, lane, w);
      }
#pragma unroll 4
      for (; j < steps; ++j) {  // unrolled: the next frames' tile loads start under this frame's chain
        frame_step<R, false>(p, tp + j * PJ, n * TF + j, lane, w);
        store_bits<R>(bits, n * TF + j, lane, w);
      }
      if (n + n_slots < n_tiles) bar_arrive(empty0 + s, kThreads);
    }
    __syncwarp();  // every lane's bits are visible to the lane that walks back

    // ---- walk back: one thread, one bit per mel frame ----
    if (lane == 0) {
      int x = t_x - 1;
      for (int y = t_y - 1; y >= 0; --y) {
        frame_x[y] = x;
        x -= load_bit<R>(bits, y, x);
      }
    }
  }
  __syncthreads();
  for (int y = tid; y < t_y; y += kThreads) {
    const size_t at = static_cast<size_t>(frame_x[y]) * Ty + y;
    p_b[at] = m_b[at];  // 1 * mask
  }
}

// ring slots (3, else 2) and whether the decision bits share the block's shared memory
struct Plan {
  int n_slots;
  bool bits_shared;
  size_t smem;
};

inline Plan plan(const Layout& l) {
  for (int slots = 3; slots >= 2; --slots) {
    const size_t need = slots * l.tile + l.frames + l.bits;
    if (need <= kSmemLimit) return {slots, true, need};
  }
  return {3, false, 3 * l.tile + l.frames};
}

template <int R>
cudaError_t launch(const float* value, const float* mask, float* path, unsigned* scratch, int B, int Tx, int Ty,
                   const Plan& pl, int vec, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mas_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(pl.smem));
  if (err != cudaSuccess) return err;
  mas_kernel<R><<<B, kThreads, pl.smem, stream>>>(value, mask, path, scratch, Tx, Ty, pl.n_slots, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Words of global scratch (32-bit) that one call needs for the decision bits:
// 0 where they fit in shared memory beside the tile ring, else
// B * T_y * max(R, 8) with R = T_x / 32 rounded up to a power of two; -1 where
// T_x exceeds 2048 or the ring and the frame index alone do not fit.
long long mas_scratch_words(int B, int Tx, int Ty) {
  if (B <= 0 || Tx <= 0 || Ty <= 0 || Tx > 32 * kMaxR) return -1;
  const Layout l = layout(Tx, Ty);
  const Plan pl = plan(l);
  if (pl.smem > kSmemLimit) return -1;
  return pl.bits_shared ? 0 : static_cast<long long>(B) * Ty * bit_words(l.R);
}

// value, mask (B, T_x, T_y) f32 contiguous -> path (B, T_x, T_y) f32, every
// element written.  scratch: mas_scratch_words(B, T_x, T_y) words, or null
// where that is 0.  Returns the first CUDA error, or 0.
int mas_path_f32(const float* value, const float* mask, float* path, unsigned* scratch,
                 int B, int Tx, int Ty, void* stream_ptr) {
  const long long need = mas_scratch_words(B, Tx, Ty);
  if (need < 0 || (need > 0 && scratch == nullptr)) return cudaErrorInvalidValue;
  const Layout l = layout(Tx, Ty);
  const Plan pl = plan(l);
  unsigned* global_bits = need > 0 ? scratch : nullptr;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int vec = (Ty % 4 == 0) && (reinterpret_cast<uintptr_t>(value) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(mask) % 16 == 0) && (reinterpret_cast<uintptr_t>(path) % 16 == 0);
  switch (l.R) {
    case 1: return launch<1>(value, mask, path, global_bits, B, Tx, Ty, pl, vec, stream);
    case 2: return launch<2>(value, mask, path, global_bits, B, Tx, Ty, pl, vec, stream);
    case 4: return launch<4>(value, mask, path, global_bits, B, Tx, Ty, pl, vec, stream);
    case 8: return launch<8>(value, mask, path, global_bits, B, Tx, Ty, pl, vec, stream);
    case 16: return launch<16>(value, mask, path, global_bits, B, Tx, Ty, pl, vec, stream);
    case 32: return launch<32>(value, mask, path, global_bits, B, Tx, Ty, pl, vec, stream);
    case 64: return launch<64>(value, mask, path, global_bits, B, Tx, Ty, pl, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

const char* mas_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
