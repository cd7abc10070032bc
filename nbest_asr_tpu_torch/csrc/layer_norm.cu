// Row LayerNorm over the f32 residual sums that gemm_bias_residual
// (gemm_wgmma.cu) writes: y = (s - mean) * rsqrt(var + eps) * scale + bias,
// statistics in f32, output bf16; for training it also writes each row's
// mean and rstd (f32, (M,)), the residuals the FFN backward's row pass
// (ffn_bwd.cu) reads.
//
// Replaces the LN tails of two TPU megakernels:
//   nbest_asr_tpu/ops/fused_attention.py:_fab_fwd_kernel (:188-194)
//   nbest_asr_tpu/ops/fused_ffn.py:_fwd_kernel (:191-200; the TPU writes
//   the statistics lane-broadcast to (n, 128), which is blocking, not
//   contract)
// On the TPU the LN runs on the VMEM-resident output tile of the second
// GEMM.  On the H100 a 128x128 GEMM tile does not span the 768-wide row
// the statistics need, so the GEMM epilogue writes the f32 residual sum
// and this kernel normalises it.
//
// What bounds it on the H100: HBM bytes -- 4 bytes read and 2 written
// per element, 4 flop each.  One warp owns one row and keeps it in
// registers (float4 loads, N <= 1024), so each element is read once.
#include "common.cuh"

namespace {

using namespace nbk;

constexpr int ROWS_PER_BLOCK = 8;
constexpr int MAX_VEC = 8;  // float4 per lane: N <= 32 * 4 * 8 = 1024

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
    layer_norm_kernel(const float* __restrict__ s,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, bf16* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, int M, int N,
                      float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= M) return;
  const int nv = N / 128;
  const float4* src = reinterpret_cast<const float4*>(s + (size_t)row * N);

  float4 v[MAX_VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    if (i < nv) {
      v[i] = src[lane + 32 * i];
      sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    }
  }
  const float mean = warp_sum(sum) / N;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    if (i < nv) {
      const float a = v[i].x - mean, b = v[i].y - mean;
      const float c = v[i].z - mean, d = v[i].w - mean;
      sq += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / N + eps);
  if (lane == 0 && mean_out != nullptr) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }

  const float4* g4 = reinterpret_cast<const float4*>(scale);
  const float4* b4 = reinterpret_cast<const float4*>(bias);
  uint2* dst = reinterpret_cast<uint2*>(y + (size_t)row * N);
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    if (i < nv) {
      const int j = lane + 32 * i;
      const float4 g = g4[j], b = b4[j];
      uint2 o;
      o.x = pack_bf16x2((v[i].x - mean) * rstd * g.x + b.x,
                        (v[i].y - mean) * rstd * g.y + b.y);
      o.y = pack_bf16x2((v[i].z - mean) * rstd * g.z + b.z,
                        (v[i].w - mean) * rstd * g.w + b.w);
      dst[j] = o;
    }
  }
}

}  // namespace

extern "C" {

// y (M, N) bf16 = LayerNorm(s (M, N) f32) * scale + bias; N % 128 == 0,
// N <= 1024.  mean_out and rstd_out (M,) f32 receive the row statistics
// unless null.
int nbk_layer_norm(const float* s, const float* scale, const float* bias,
                   void* y, float* mean_out, float* rstd_out, int M, int N,
                   float eps, void* stream) {
  const int blocks = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  layer_norm_kernel<<<blocks, ROWS_PER_BLOCK * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      s, scale, bias, static_cast<bf16*>(y), mean_out, rstd_out, M, N, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"

// ---------------------------------------------------------------------
// Fused residual LayerNorm, forward and backward: y = LN(x + r).
//
// Replaces the two Pallas bodies of nbest_asr_tpu/ops/fused_ln.py:
//   _fwd_kernel (:33): s = f32(x) + f32(r), f32 mean and rstd per row,
//     y in x's dtype (the TPU broadcasts the statistics across 128 lanes;
//     here they are (M,) f32);
//   _bwd_kernel (:79): xhat from the saved statistics,
//     dx = (g - mean(g) - xhat * mean(g * xhat)) * rstd with g = dy*scale,
//     written once and returned for both x and r; dscale = sum dy * xhat
//     and dbias = sum dy over rows, which the TPU carries across its
//     sequential grid in one VMEM accumulator.
// On the H100 blocks run in no order, so the column sums become per-block
// partials in a workspace and a second kernel adds them over blocks in a
// fixed order: deterministic, no atomics.
//
// What bounds them: HBM bytes -- forward 2 x 2 bytes read and 2 written
// per element (bf16), backward 3 x 2 read and 2 written, a few flops
// each.  One warp owns one row and keeps it in registers (four columns a
// lane per 128, N = 128 * NV <= 1024), so each element is read once.
// ---------------------------------------------------------------------

namespace {

using namespace nbk;

template <typename T, int NV>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
    residual_ln_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ y,
                       float* __restrict__ mean_out,
                       float* __restrict__ rstd_out, int M, float eps) {
  constexpr int N = 128 * NV;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t base = (size_t)row * N;

  float v[NV][4];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 4 * (lane + 32 * i);
    const float4 a = load4(x + base + c), b = load4(r + base + c);
    v[i][0] = __fadd_rn(a.x, b.x);
    v[i][1] = __fadd_rn(a.y, b.y);
    v[i][2] = __fadd_rn(a.z, b.z);
    v[i][3] = __fadd_rn(a.w, b.w);
    sum += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
  }
  const float mean = __fdiv_rn(warp_sum(sum), (float)N);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[i][j] = __fsub_rn(v[i][j], mean);
      sq = __fmaf_rn(v[i][j], v[i][j], sq);
    }
  }
  const float rstd = rsqrtf(__fdiv_rn(warp_sum(sq), (float)N) + eps);
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 4 * (lane + 32 * i);
    const float4 g = load4(scale + c), b = load4(bias + c);
    const float gg[4] = {g.x, g.y, g.z, g.w}, bb[4] = {b.x, b.y, b.z, b.w};
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j], rstd), gg[j]), bb[j]);
    store4(y + base + c, o);
  }
}

// Row pass of the backward.  Each warp walks rows row0, row0 + W, ...
// (W = warps in the grid), writes dx, and keeps its columns' dy * xhat
// and dy sums in registers; the block adds its warps' sums in warp order
// in shared memory and writes one partial row per sum to
// part[block][2][N].
template <typename T, int NV>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
    residual_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                           const T* __restrict__ dy,
                           const float* __restrict__ scale,
                           const float* __restrict__ mean,
                           const float* __restrict__ rstd,
                           T* __restrict__ dx, float* __restrict__ part,
                           int M) {
  constexpr int N = 128 * NV;
  __shared__ float red[2][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ps[NV][4], pb[NV][4];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ps[i][j] = pb[i][j] = 0.f;

  for (int row = blockIdx.x * ROWS_PER_BLOCK + warp; row < M;
       row += gridDim.x * ROWS_PER_BLOCK) {
    const size_t base = (size_t)row * N;
    const float mu = mean[row], rs = rstd[row];
    float xh[NV][4], g[NV][4];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = 4 * (lane + 32 * i);
      const float4 a = load4(x + base + c), b = load4(r + base + c);
      const float4 d = load4(dy + base + c), sc = load4(scale + c);
      const float sv[4] = {__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                           __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w)};
      const float dd[4] = {d.x, d.y, d.z, d.w};
      const float gg[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xh[i][j] = __fmul_rn(__fsub_rn(sv[j], mu), rs);
        g[i][j] = __fmul_rn(dd[j], gg[j]);
        s1 = __fadd_rn(s1, g[i][j]);
        s2 = __fadd_rn(s2, __fmul_rn(g[i][j], xh[i][j]));
        ps[i][j] = __fadd_rn(ps[i][j], __fmul_rn(dd[j], xh[i][j]));
        pb[i][j] = __fadd_rn(pb[i][j], dd[j]);
      }
    }
    const float m1 = __fdiv_rn(warp_sum(s1), (float)N);
    const float m2 = __fdiv_rn(warp_sum(s2), (float)N);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = __fmul_rn(__fsub_rn(__fsub_rn(g[i][j], m1),
                                   __fmul_rn(xh[i][j], m2)),
                         rs);
      store4(dx + base + 4 * (lane + 32 * i), o);
    }
  }

  for (int w = 0; w < ROWS_PER_BLOCK; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * (lane + 32 * i) + j;
          red[0][c] = w == 0 ? ps[i][j] : red[0][c] + ps[i][j];
          red[1][c] = w == 0 ? pb[i][j] : red[1][c] + pb[i][j];
        }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.x * 2 * N;
  for (int c = threadIdx.x; c < 2 * N; c += blockDim.x)
    out[c] = red[c / N][c % N];
}

// out[q * N + c] = sum over blocks b of part[b][q][c], q = 0 (dscale) or
// 1 (dbias): one block per 32 columns of the (2, N) result; warp w adds
// blocks w, w + 8, ... in order, then warp 0 adds the eight warp sums in
// order.
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
    column_sum_kernel(const float* __restrict__ part,
                      float* __restrict__ dscale, float* __restrict__ dbias,
                      int blocks, int N) {
  __shared__ float acc[ROWS_PER_BLOCK][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;     // in [0, 2N)
  float s = 0.f;
  if (col < 2 * N)
    for (int b = warp; b < blocks; b += ROWS_PER_BLOCK)
      s = __fadd_rn(s, part[(size_t)b * 2 * N + col]);
  acc[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < 2 * N) {
    float t = acc[0][lane];
    for (int w = 1; w < ROWS_PER_BLOCK; ++w) t = __fadd_rn(t, acc[w][lane]);
    (col < N ? dscale : dbias)[col % N] = t;
  }
}

template <typename T>
int residual_ln(const void* x, const void* r, const float* scale,
                const float* bias, void* y, float* mean, float* rstd, int M,
                int N, float eps, cudaStream_t st) {
  const int blocks = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  NBK_ROW_WIDTHS(N, residual_ln_kernel<T, NV>
                 <<<blocks, ROWS_PER_BLOCK * 32, 0, st>>>(
                     static_cast<const T*>(x), static_cast<const T*>(r),
                     scale, bias, static_cast<T*>(y), mean, rstd, M, eps));
  return (int)cudaGetLastError();
}

template <typename T>
int residual_ln_bwd(const void* x, const void* r, const void* dy,
                    const float* scale, const float* mean, const float* rstd,
                    void* dx, float* part, float* dscale, float* dbias, int M,
                    int N, int blocks, cudaStream_t st) {
  NBK_ROW_WIDTHS(N, residual_ln_bwd_kernel<T, NV>
                 <<<blocks, ROWS_PER_BLOCK * 32, 0, st>>>(
                     static_cast<const T*>(x), static_cast<const T*>(r),
                     static_cast<const T*>(dy), scale, mean, rstd,
                     static_cast<T*>(dx), part, M));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  column_sum_kernel<<<(2 * N + 31) / 32, ROWS_PER_BLOCK * 32, 0, st>>>(
      part, dscale, dbias, blocks, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (M, N) = LN(x + r) * scale + bias in x's dtype (bf16, or f32 when
// is_f32), with the row mean and rstd (M,) f32; N = 128 * k, k <= 8.
int nbk_residual_layer_norm(const void* x, const void* r, const float* scale,
                            const float* bias, void* y, float* mean,
                            float* rstd, int M, int N, float eps, int is_f32,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f32 ? residual_ln<float>(x, r, scale, bias, y, mean, rstd, M, N,
                                     eps, st)
                : residual_ln<bf16>(x, r, scale, bias, y, mean, rstd, M, N,
                                    eps, st);
}

// dx (M, N) in x's dtype, dscale and dbias (N,) f32 from x, r, dy (M, N)
// and the forward's statistics; part is a (blocks, 2, N) f32 workspace,
// blocks the row pass's grid (its warps stride over the rows).
int nbk_residual_layer_norm_bwd(const void* x, const void* r, const void* dy,
                                const float* scale, const float* mean,
                                const float* rstd, void* dx, float* part,
                                float* dscale, float* dbias, int M, int N,
                                int blocks, int is_f32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f32 ? residual_ln_bwd<float>(x, r, dy, scale, mean, rstd, dx,
                                         part, dscale, dbias, M, N, blocks,
                                         st)
                : residual_ln_bwd<bf16>(x, r, dy, scale, mean, rstd, dx, part,
                                        dscale, dbias, M, N, blocks, st);
}

}  // extern "C"
