// The FFN block backward's row pass: LayerNorm backward and the split of
// its gradient into the residual branch and the second dropout.
//
// Replaces the row-local head of the TPU backward kernel
// nbest_asr_tpu/ops/fused_ffn.py:_bwd_kernel (:224), `_row_grads`
// (:203-221), and its emissions of dy2 and xhat (:259-260).  Per row, from
// the forward's saved bf16 y2d (not its f32 sum, :208), x and statistics:
//   s    = f32(y2d) + f32(x)
//   xhat = (s - mean) * rstd
//   gl   = f32(dy) * ln_scale
//   ds   = (gl - mean(gl) - xhat * mean(gl * xhat)) * rstd
//   dy2  = bf16(drop2(ds))   (the forward's second mask, Philox stream 2)
// and writes dy2 and xhat in bf16 and ds in f32 (the residual branch of
// dx, which the dx GEMM's epilogue adds before its one rounding).
//
// What bounds it on the H100: HBM bytes -- 6 bytes read and 8 written per
// element (plus 16 bytes of Philox work per four elements, in registers).
// One warp owns one row and keeps it in registers (N <= 1024), so each
// input is read once and the two row means need no second pass.
#include "common.cuh"
#include "philox.cuh"

namespace {

using namespace nbk;

constexpr int ROWS_PER_BLOCK = 8;
constexpr int MAX_VEC = 8;  // 4 columns per lane per step: N <= 1024

__device__ __forceinline__ float4 load_bf16x4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__bfloat162float(a.x), __bfloat162float(a.y),
                     __bfloat162float(b.x), __bfloat162float(b.y));
}

__device__ __forceinline__ void store_bf16x4(bf16* p, float a, float b,
                                             float c, float d) {
  uint2 u;
  u.x = pack_bf16x2(a, b);
  u.y = pack_bf16x2(c, d);
  *reinterpret_cast<uint2*>(p) = u;
}

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
    ffn_bwd_rows_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ y2d,
                        const bf16* __restrict__ dy,
                        const float* __restrict__ ls,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        bf16* __restrict__ dy2, bf16* __restrict__ xhat_out,
                        float* __restrict__ ds_out, int M, int N,
                        DropParams drop) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= M) return;
  const int nv = N / 128;
  const size_t base = (size_t)row * N;
  const float mu = mean[row], rs = rstd[row];

  float xh[MAX_VEC][4], gl[MAX_VEC][4];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    if (i < nv) {
      const int c = 4 * (lane + 32 * i);
      const float4 xv = load_bf16x4(x + base + c);
      const float4 yv = load_bf16x4(y2d + base + c);
      const float4 dv = load_bf16x4(dy + base + c);
      const float4 g = *reinterpret_cast<const float4*>(ls + c);
      const float sv[4] = {__fadd_rn(yv.x, xv.x), __fadd_rn(yv.y, xv.y),
                           __fadd_rn(yv.z, xv.z), __fadd_rn(yv.w, xv.w)};
      const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
      const float gg[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xh[i][j] = __fmul_rn(__fsub_rn(sv[j], mu), rs);
        gl[i][j] = __fmul_rn(dd[j], gg[j]);
        s1 = __fadd_rn(s1, gl[i][j]);
        s2 = __fadd_rn(s2, __fmul_rn(gl[i][j], xh[i][j]));
      }
    }
  }
  const float m1 = __fdiv_rn(warp_sum(s1), (float)N);
  const float m2 = __fdiv_rn(warp_sum(s2), (float)N);

#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    if (i < nv) {
      const int c = 4 * (lane + 32 * i);
      float d[4], o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[j] = __fmul_rn(__fsub_rn(__fsub_rn(gl[i][j], m1),
                                   __fmul_rn(xh[i][j], m2)),
                         rs);
      *reinterpret_cast<float4*>(ds_out + base + c) =
          make_float4(d[0], d[1], d[2], d[3]);
      if (drop.on) {
        const uint4 w = philox_group(drop, row, c);
        o[0] = drop_value(drop, d[0], w.x);
        o[1] = drop_value(drop, d[1], w.y);
        o[2] = drop_value(drop, d[2], w.z);
        o[3] = drop_value(drop, d[3], w.w);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = d[j];
      }
      store_bf16x4(dy2 + base + c, o[0], o[1], o[2], o[3]);
      store_bf16x4(xhat_out + base + c, xh[i][0], xh[i][1], xh[i][2],
                   xh[i][3]);
    }
  }
}

}  // namespace

extern "C" {

// x, y2d, dy (M, N) bf16; ln_scale (N,) f32; mean, rstd (M,) f32 ->
// dy2, xhat (M, N) bf16 and ds (M, N) f32.  N % 128 == 0, N <= 1024.
int nbk_ffn_bwd_rows(const void* x, const void* y2d, const void* dy,
                     const float* ls, const float* mean, const float* rstd,
                     void* dy2, void* xhat, float* ds, int M, int N,
                     unsigned long long seed, int stream, unsigned thresh,
                     float inv_keep, int drop_on, void* cuda_stream) {
  const DropParams d = make_drop(seed, stream, thresh, inv_keep, drop_on);
  const int blocks = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  ffn_bwd_rows_kernel<<<blocks, ROWS_PER_BLOCK * 32, 0,
                        static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y2d),
      static_cast<const bf16*>(dy), ls, mean, rstd, static_cast<bf16*>(dy2),
      static_cast<bf16*>(xhat), ds, M, N, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
