// Hopper warpgroup MMA (wgmma) pieces shared by the kernels that run it
// (gemm_wgmma.cu, seg_attention.cu, seg_attention_bwd.cu): shared-memory
// descriptors of 128- and 64-byte-swizzled tiles, the bf16 products the
// attention kernels issue, the fence / commit / wait of the asynchronous
// products, a warpgroup barrier, the accumulator pin, and the proxy fence
// that makes thread-written shared memory visible to wgmma.  sm_90a only.
//
// A 128-byte-swizzled tile is rows of 64 bf16 (128 bytes) whose 16-byte
// chunk c of row r sits at chunk c ^ (r % 8), 1024-byte aligned: what TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes, and what swizzle128 below gives a
// thread that copies a chunk itself.  A 64-byte-swizzled tile is rows of
// 32 bf16 (64 bytes) whose chunk c of row r sits at chunk c ^ ((r / 2) %
// 4), 512-byte aligned (swizzle64).
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

// The same, 64-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc64(const void* p, unsigned lbo,
                                                unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (2ull << 62);
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

// Pins the accumulators (f32, or an s8 product's s32) around asynchronous
// wgmma, so the compiler moves no access to them across an issue or a
// wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// Byte offset of 16-byte chunk c (0 .. 3) of row r in a 64-byte-swizzled
// tile.
__device__ __forceinline__ int swizzle64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// d (64 x 64) (+)= A (64 x 16, K-major, shared) * B (16 x 64, K-major,
// shared); the first k-step of a product passes scale_d = 0.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32) (+)= A (64 x 16, K-major, shared) * B (16 x 32, K-major,
// shared); the first k-step of a product passes scale_d = 0.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) (+)= A (64 x 16, four bf16x2 registers a thread: the
// m16n8k16 A fragment of the warp's 16 rows) * B (16 x 64, MN-major in
// shared memory, transpose-B).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const unsigned* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (64 x 32) (+)= A (64 x 16 from registers, as wgmma_rs_n64's) * B (16
// x 32, MN-major in shared memory, transpose-B).
__device__ __forceinline__ void wgmma_rs_n32(float* d, const unsigned* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (64 x 64) += A^T * B with both operands MN-major in shared memory
// (transpose-A, transpose-B): A^T (64 x 16) from a tile stored K-rows of
// 64 M values, B (16 x 64) from a tile stored K-rows of 64 N values; the
// first k-step of a product passes scale_d = 0.
__device__ __forceinline__ void wgmma_tt_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32) += A^T * B as wgmma_tt_n64, B (16 x 32) from a tile stored
// K-rows of 32 N values.
__device__ __forceinline__ void wgmma_tt_n32(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Barrier of warpgroup wg's 128 threads (named barrier 1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

}  // namespace nbk
