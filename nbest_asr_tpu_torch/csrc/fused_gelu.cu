// Fused bias + GELU, forward and backward, elementwise over (M, N):
//   bias_gelu:     y  = gelu(s),                 s = f32(x) + b[col]
//   bias_gelu_bwd: dx = dy * (cdf(s) + s * pdf(s))
// with cdf(s) = 0.5 * (1 + erf(s / sqrt 2)) and erf from Abramowitz &
// Stegun 7.1.26 (common.cuh:erf_as), in f32, output in x's dtype.
//
// Replaces nbest_asr_tpu/ops/fused_gelu.py:_fwd_kernel (:41) and
// _bwd_kernel (:47).  The TPU blocks them as (256, 1024) tiles with a
// (1, 1024) bias block; here a grid-stride loop walks groups of V
// consecutive elements of the flat (M, N) array (N % V == 0, so a group
// never crosses a row) and reads the group's V bias values by column.
// dbias, the column sum of dx, stays outside the kernel as in JAX (:85).
//
// What bounds them on the H100: HBM bytes (forward 2 read and 2 written
// per bf16 element, backward 4 read and 2 written; the bias is 12 KB and
// stays in L1) and, as much, instruction issue: A&S in separately rounded
// steps that no FMA may contract, an accurate expf (two in the backward)
// and the reciprocal cost the backward ~60 instructions an element, about
// as long at 8192 x 3072 as its bytes take.  So the loop keeps the bytes
// moving under the math (PERF.md, Findings): each thread takes V = 8
// elements a step (16-byte loads of bf16 x and dy, two in f32; two float4
// of bias from L1) and issues the next step's loads before this step's
// math (a register double buffer: the raw words are held and converted at
// use, so no instruction waits on them early).  The grid is as many blocks
// as the build's registers let reside on every SM.  Where N % 8 != 0 or an
// operand is off a 16-byte boundary, the V = 4 instance of the same
// template runs (8-byte bf16 loads).  Both instances do the same
// arithmetic in the same order, so their outputs are equal bit for bit.
#include "common.cuh"

namespace {

using namespace nbk;

constexpr int THREADS = 256;

// BYTES of consecutive elements as raw words, held in registers
template <int BYTES>
struct Raw {
  uint4 w[BYTES / 16];
};
template <>
struct Raw<8> {
  uint2 w[1];
};

template <int BYTES>
__device__ __forceinline__ Raw<BYTES> load_raw(const void* p) {
  Raw<BYTES> r;
#pragma unroll
  for (int i = 0; i < BYTES / 16; ++i)
    r.w[i] = reinterpret_cast<const uint4*>(p)[i];
  return r;
}
template <>
__device__ __forceinline__ Raw<8> load_raw<8>(const void* p) {
  Raw<8> r;
  r.w[0] = *reinterpret_cast<const uint2*>(p);
  return r;
}

// 32-bit word i of the raw words (i a constant once unrolled)
__device__ __forceinline__ unsigned word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}
__device__ __forceinline__ unsigned word(const uint2& q, int i) {
  return i == 0 ? q.x : q.y;
}
template <int BYTES>
__device__ __forceinline__ unsigned word(const Raw<BYTES>& r, int i) {
  constexpr int PER = sizeof(r.w[0]) / 4;
  return word(r.w[i / PER], i % PER);
}

// V values of x's type, as raw words, to f32
template <int V, int BYTES>
__device__ __forceinline__ void to_f32(const Raw<BYTES>& r, float (&f)[V],
                                       const float*) {
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = __uint_as_float(word(r, i));
}

template <int V, int BYTES>
__device__ __forceinline__ void to_f32(const Raw<BYTES>& r, float (&f)[V],
                                       const bf16*) {
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {  // a bf16 is the high half of its f32
    const unsigned u = word(r, i);
    f[2 * i] = __uint_as_float(u << 16);
    f[2 * i + 1] = __uint_as_float(u & 0xFFFF0000u);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

template <int V>
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[V]) {
  if (V == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<uint2*>(p + i) =
          make_uint2(pack_bf16x2(v[i], v[i + 1]),
                     pack_bf16x2(v[i + 2], v[i + 3]));
  }
}

__device__ __forceinline__ float gelu_cdf(float s) {
  return __fmul_rn(0.5f, __fadd_rn(1.f, erf_as(__fmul_rn(s, INV_SQRT2))));
}

// One step's HBM operands: x and, backward, dy.  (The bias is read at use,
// from L1: held a step ahead too, it ran no faster.)
template <typename T, int V, bool BWD>
struct Step {
  Raw<V * sizeof(T)> x, dy;
};

template <typename T, int V, bool BWD>
__device__ __forceinline__ Step<T, V, BWD> load_step(
    const T* __restrict__ x, const T* __restrict__ dy, size_t e) {
  Step<T, V, BWD> s = {};
  s.x = load_raw<V * sizeof(T)>(x + e);
  if (BWD) s.dy = load_raw<V * sizeof(T)>(dy + e);
  return s;
}

template <typename T, int V, bool BWD>
__global__ void __launch_bounds__(THREADS)
    bias_gelu_kernel(const T* __restrict__ x, const float* __restrict__ b,
                     const T* __restrict__ dy, T* __restrict__ out,
                     size_t groups, int N) {
  const size_t q0 = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * THREADS;
  if (q0 >= groups) return;
  // the group's first column, advanced by the stride's columns mod N
  // (no 64-bit division in the loop)
  const int step = (int)((V * stride) % (size_t)N);
  int col = (int)((V * q0) % (size_t)N);
  Step<T, V, BWD> cur = load_step<T, V, BWD>(x, dy, V * q0);
  for (size_t q = q0; q < groups; q += stride) {
    // the next step's loads go out before this step's math
    Step<T, V, BWD> nxt = cur;
    if (q + stride < groups)
      nxt = load_step<T, V, BWD>(x, dy, V * (q + stride));
    float xv[V], bv[V], s[V], o[V];
    to_f32<V>(cur.x, xv, x);
    to_f32<V>(load_raw<V * 4>(b + col), bv, b);
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = __fadd_rn(xv[j], bv[j]);
    if (BWD) {
      float dd[V];
      to_f32<V>(cur.dy, dd, dy);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        // pdf = exp((-0.5 * s) * s) / sqrt(2 pi) (fused_gelu.py:50)
        const float pdf = __fmul_rn(
            expf(__fmul_rn(__fmul_rn(-0.5f, s[j]), s[j])), INV_SQRT2PI);
        o[j] = __fmul_rn(dd[j], __fadd_rn(gelu_cdf(s[j]),
                                          __fmul_rn(s[j], pdf)));
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = __fmul_rn(s[j], gelu_cdf(s[j]));
    }
    store_vec<V>(out + V * q, o);
    cur = nxt;
    col += step;
    if (col >= N) col -= N;
  }
}

template <typename T, int V, bool BWD>
int launch_v(const void* x, const float* b, const void* dy, void* out,
             int M, int N, cudaStream_t st) {
  static int per_sm = 0;  // resident blocks per SM for this instance
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bias_gelu_kernel<T, V, BWD>, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
  }
  const size_t groups = (size_t)M * N / V;
  const size_t want = (groups + THREADS - 1) / THREADS;
  const size_t full = (size_t)per_sm * sm_count();
  const int blocks = (int)(want < full ? want : full);
  bias_gelu_kernel<T, V, BWD><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(x), b, static_cast<const T*>(dy),
      static_cast<T*>(out), groups, N);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// V = 8 where N % 8 == 0 and every operand is 16-byte aligned, else V = 4
template <typename T, bool BWD>
int launch(const void* x, const float* b, const void* dy, void* out, int M,
           int N, cudaStream_t st) {
  const bool wide = N % 8 == 0 && aligned16(x) && aligned16(b) &&
                    aligned16(out) && (!BWD || aligned16(dy));
  return wide ? launch_v<T, 8, BWD>(x, b, dy, out, M, N, st)
              : launch_v<T, 4, BWD>(x, b, dy, out, M, N, st);
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
