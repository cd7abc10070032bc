// Hopper warpgroup MMA (wgmma) pieces shared by the kernels that run it
// (gemm_wgmma.cu, seg_attention.cu): shared-memory descriptors of
// 128-byte-swizzled tiles, the fence / commit / wait of the asynchronous
// products, the accumulator pin, and the proxy fence that makes
// thread-written shared memory visible to wgmma.  sm_90a only.
//
// A 128-byte-swizzled tile is rows of 64 bf16 (128 bytes) whose 16-byte
// chunk c of row r sits at chunk c ^ (r % 8), 1024-byte aligned: what TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes, and what swizzle128 below gives a
// thread that copies a chunk itself.
#pragma once

#include "common.cuh"

namespace nbk {

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulators around asynchronous wgmma, so the compiler moves
// no access to them across an issue or a wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Makes this thread's shared-memory writes (st.shared, cp.async) visible
// to the async proxy that wgmma and TMA read through; a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk c (0 .. 7) of row r in a 128-byte-swizzled
// tile.
__device__ __forceinline__ int swizzle128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

}  // namespace nbk
