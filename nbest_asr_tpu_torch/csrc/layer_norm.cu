// Row LayerNorm over the f32 residual sums that gemm_bias_residual
// (gemm.cu) writes: y = (s - mean) * rsqrt(var + eps) * scale + bias,
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
