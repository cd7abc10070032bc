// Fused bias + GELU, forward and backward, elementwise over (M, N):
//   bias_gelu:     y  = gelu(s),                 s = f32(x) + b[col]
//   bias_gelu_bwd: dx = dy * (cdf(s) + s * pdf(s))
// with cdf(s) = 0.5 * (1 + erf(s / sqrt 2)) and erf from Abramowitz &
// Stegun 7.1.26 (common.cuh:erf_as), in f32, output in x's dtype.
//
// Replaces nbest_asr_tpu/ops/fused_gelu.py:_fwd_kernel (:41) and
// _bwd_kernel (:47).  The TPU blocks them as (256, 1024) tiles with a
// (1, 1024) bias block; here a grid-stride loop walks groups of four
// consecutive elements of the flat (M, N) array (N % 4 == 0, so a group
// never crosses a row) and reads the group's four bias values by column.
// dbias, the column sum of dx, stays outside the kernel as in JAX (:85).
//
// What bounds them on the H100: HBM bytes -- forward 2 bytes read and 2
// written per bf16 element, backward 4 read and 2 written, ~30 flops and
// one expf each (the bias is 12 KB and stays in L1/L2).
#include "common.cuh"

namespace {

using namespace nbk;

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;   // 8 blocks of 256 threads per SM

__device__ __forceinline__ float gelu_cdf(float s) {
  return __fmul_rn(0.5f, __fadd_rn(1.f, erf_as(__fmul_rn(s, INV_SQRT2))));
}

template <typename T, bool BWD>
__global__ void __launch_bounds__(THREADS)
    bias_gelu_kernel(const T* __restrict__ x, const float* __restrict__ b,
                     const T* __restrict__ dy, T* __restrict__ out,
                     size_t groups, int N) {
  const size_t q0 = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * THREADS;
  // the group's first column, advanced by the stride's columns mod N
  // (no 64-bit division in the loop)
  const int step = (int)((4 * stride) % (size_t)N);
  int col = (int)((4 * q0) % (size_t)N);
  for (size_t q = q0; q < groups; q += stride) {
    const size_t e = 4 * q;
    const float4 xv = load4(x + e), bv = load4(b + col);
    const float s[4] = {__fadd_rn(xv.x, bv.x), __fadd_rn(xv.y, bv.y),
                        __fadd_rn(xv.z, bv.z), __fadd_rn(xv.w, bv.w)};
    float o[4];
    if (BWD) {
      const float4 d = load4(dy + e);
      const float dd[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // pdf = exp((-0.5 * s) * s) / sqrt(2 pi) (fused_gelu.py:50)
        const float pdf = __fmul_rn(
            expf(__fmul_rn(__fmul_rn(-0.5f, s[j]), s[j])), INV_SQRT2PI);
        o[j] = __fmul_rn(dd[j], __fadd_rn(gelu_cdf(s[j]),
                                          __fmul_rn(s[j], pdf)));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = __fmul_rn(s[j], gelu_cdf(s[j]));
    }
    store4(out + e, o);
    col += step;
    if (col >= N) col -= N;
  }
}

template <typename T, bool BWD>
int launch(const void* x, const float* b, const void* dy, void* out, int M,
           int N, cudaStream_t st) {
  const size_t groups = (size_t)M * N / 4;
  const size_t want = (groups + THREADS - 1) / THREADS;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  bias_gelu_kernel<T, BWD><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(x), b, static_cast<const T*>(dy),
      static_cast<T*>(out), groups, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (M, N) = gelu(x + b) in x's dtype (bf16, or f32 when is_f32); b (N,)
// f32; N % 4 == 0, M * N > 0.
int nbk_bias_gelu(const void* x, const float* b, void* y, int M, int N,
                  int is_f32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch<float, false>(x, b, nullptr, y, M, N, st)
                : launch<bf16, false>(x, b, nullptr, y, M, N, st);
}

// dx (M, N) = dy * gelu'(x + b) in x's dtype; x, dy (M, N), b (N,) f32.
int nbk_bias_gelu_bwd(const void* x, const float* b, const void* dy,
                      void* dx, int M, int N, int is_f32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch<float, true>(x, b, dy, dx, M, N, st)
                : launch<bf16, true>(x, b, dy, dx, M, N, st);
}

}  // extern "C"
