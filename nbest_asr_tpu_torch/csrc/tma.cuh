// Hopper TMA (cp.async.bulk.tensor) and mbarrier pieces shared by the
// warp-specialised kernels (gemm_wgmma.cu, flash_attention_bwd.cu): the
// barriers of a producer / consumer ring, tile loads of 2-D and 3-D tensor
// maps, and, host side, the tensor-map encoder.  sm_90a (TMA and mbarriers
// work on sm_90 too).
//
// Tensor maps come from cuTensorMapEncodeTiled, fetched through
// cudaGetDriverEntryPointByVersion, so nothing links against libcuda.  A
// map's inner box is the swizzle's width: 128 bytes (64 bf16 or 128 s8)
// with the 128-byte swizzle, or 64 bytes with the 64-byte swizzle (the
// last 32 columns of a 96-column flash head), which is what wgmma.cuh's
// descriptors read; a box that reaches past a dimension's end is
// zero-filled.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace nbk {

// --- mbarriers --------------------------------------------------------- //

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA); a
// __syncthreads follows.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Arrives with release semantics: this thread's earlier shared-memory
// writes are visible to a thread that waits for the phase.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned addr,
                                              unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits for the phase of parity `parity` to complete.  A phase error would
// hang the card; after ~2^35 cycles (~20 s) of waiting the kernel traps
// instead, so the launch fails with an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// --- TMA loads --------------------------------------------------------- //

// 2-D tile load (c0 the inner coordinate), completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// 3-D tile load (c0 the inner coordinate), completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// --- host side --------------------------------------------------------- //

inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A tensor map of a RANK-dimensional bf16 or s8 tensor (dims[0] the
// contiguous one; strides[i] the byte stride of dimension i + 1, a multiple
// of 16) in boxes of box[0] x ... values, box[0] the swizzle's width.
template <int RANK>
int encode(CUtensorMap* map, bool s8, const void* ptr,
           const cuuint64_t (&dims)[RANK],
           const cuuint64_t (&strides)[RANK - 1],
           const cuuint32_t (&box)[RANK],
           CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint32_t elem[RANK];
  for (int i = 0; i < RANK; ++i) elem[i] = 1;
  const CUresult r = fn(map,
                        s8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        RANK, const_cast<void*>(ptr), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace nbk
