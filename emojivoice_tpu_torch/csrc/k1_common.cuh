// What K1's two libraries share: csrc/mrf.cu (f32 mode, 3xTF32) and csrc/mrf_bf16.cu (bf16 mode) each include
// it and build into a shared library of their own.  The primitives (mbarriers, bulk copies, wgmma fences,
// shared-memory descriptors) and the contract of the entry points: the four epilogue modes and the error string.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float SLOPE = 0.1f;           // the leaky ReLU's slope
constexpr int kSmemLimit = 232448;      // 227 KB a block can use on sm_90

// The epilogue of a conv (or of a dilation unit) into out; the entry points take it as `mode`.
enum Epilogue : int {
  kStore = 0,      // out = conv
  kResidual = 1,   // out = res + conv          (res may alias out: one thread reads and writes an element)
  kMeanFirst = 2,  // out = (res + conv) * scale
  kMeanAcc = 3,    // out += (res + conv) * scale
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier and bulk-copy (TMA, one dimension) primitives
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to shared memory; the barrier counts them
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// until at most N commit groups of this warpgroup are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// Shared-memory matrix descriptor, no swizzle, K-major: 8 rows × 16 bytes per core matrix; lbo = bytes between
// core matrices along K, sbo = along M or N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// the accumulator operands of a wgmma: d[i] ... d[i + 15], read and written
#define K1_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define K1_D16(i) K1_D4(i), K1_D4(i + 4), K1_D4(i + 8), K1_D4(i + 12)

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

}  // namespace

// The message of an error code that an entry point returned.
extern "C" const char* mrf_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
