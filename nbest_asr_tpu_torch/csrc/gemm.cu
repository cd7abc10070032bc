// Tensor-core GEMMs with fused epilogues: the four weight products of an
// encoder layer (QKV, attention out-projection, FFN-in, FFN-out).
//
// Replaces the in-kernel GEMMs of two TPU megakernels:
//   nbest_asr_tpu/ops/fused_attention.py:_fab_fwd_kernel (:152)
//     - `_qkv_gemm` (:143)            -> gemm_bias_act, act = none
//     - out-proj `ctx @ wo + bo` (:182) -> gemm_bias_residual
//   nbest_asr_tpu/ops/fused_ffn.py:_fwd_kernel (:166)
//     - `_gelu_slice` (:153)          -> gemm_bias_act, act = erf-GELU
//     - `gd @ w2 + b2` (:181-185)      -> gemm_bias_residual
// The TPU kernels hold both weight matrices resident in VMEM (9.4 MB for
// the FFN pair); an SM has 227 KB of shared memory, so here each GEMM
// streams 128x32 / 32x128 bf16 tiles of A and W through a 3-stage
// cp.async ring and keeps its 128x128 f32 accumulator tile in registers.
//
// What bounds it on the H100: at BERT-base shapes (M = 64 x 256 rows,
// K, N in {768, 2304, 3072}) every GEMM sits far above the bf16 ridge
// (~295 flop/byte), so tensor-core issue rate bounds it.  This first
// version uses mma.sync (the sm_80 path, roughly two thirds of Hopper's
// wgmma peak at best) with ldmatrix fragment loads from padded,
// conflict-free shared tiles; wgmma + TMA is later work.
//
// Epilogue numerics follow the TPU kernels exactly: f32 accumulation,
// + f32 bias, ONE bf16 rounding, then
//   act none : store bf16
//   act gelu : gelu_erf in f32 on the rounded value (erff, exact erf --
//              not the A&S polynomial the TPU kernel needs), store bf16
//   residual : store f32(bf16 result) + f32(residual) as f32, the input
//              of the row LayerNorm kernel (layer_norm.cu)
#include "common.cuh"

namespace {

using namespace nbk;

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int A_LD = BK + 8;  // 80-byte rows: 16-B aligned, ldmatrix
constexpr int B_LD = BN + 8;  // 272-byte rows    conflict-free
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;

enum { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

__device__ __forceinline__ void load_stage(bf16* sA, bf16* sB,
                                           const bf16* __restrict__ A,
                                           const bf16* __restrict__ W, int M,
                                           int N, int K, int m0, int n0,
                                           int k0, int tid) {
  // A tile: 128 rows x 32 cols = 512 chunks of 8 bf16, two per thread;
  // rows past M are zero-filled.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 2, col = (c & 3) * 8;
    const int gr = m0 + r;
    const bool ok = gr < M;
    cp_async_16(sA + r * A_LD + col, A + (size_t)(ok ? gr : 0) * K + k0 + col,
                ok);
  }
  // W tile: 32 rows x 128 cols (N % 128 == 0 and K % 32 == 0 are
  // checked by the wrapper).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 4, col = (c & 15) * 8;
    cp_async_16(sB + r * B_LD + col, W + (size_t)(k0 + r) * N + n0 + col,
                true);
  }
}

template <int EPI>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                const float* __restrict__ bias, const bf16* __restrict__ resid,
                void* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + STAGES * A_STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2;  // 64-row half of the block tile
  const int wn = warp & 3;   // 32-col quarter
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = K / BK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage(sA + s * A_STAGE, sB + s * B_STAGE, A, W, M, N, K, m0, n0,
                 s * BK, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the slot consumed in iteration kt-1 (free after the barrier)
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      load_stage(sA + (nk % STAGES) * A_STAGE, sB + (nk % STAGES) * B_STAGE,
                 A, W, M, N, K, m0, n0, nk * BK, tid);
    cp_async_commit();

    const bf16* a = sA + (kt % STAGES) * A_STAGE;
    const bf16* b = sB + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane & 15);
        const int c = kk + (lane >> 4) * 8;
        ldmatrix_x4(af[mi], a + r * A_LD + c);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // W is (k, n) row-major: transposed 8x8 loads give B fragments;
        // matrices = (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
        // (k 8-15, n 8-15) -> b0,b1 of n-tile 2nj and of 2nj+1
        const int r = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = wn * 32 + nj * 16 + (lane >> 4) * 8;
        unsigned t[4];
        ldmatrix_x4_trans(t, b + r * B_LD + c);
        bfr[2 * nj][0] = t[0];
        bfr[2 * nj][1] = t[1];
        bfr[2 * nj + 1][0] = t[2];
        bfr[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (row >= M) continue;
        float v0 = round_bf16(acc[mi][ni][2 * half] + b0);
        float v1 = round_bf16(acc[mi][ni][2 * half + 1] + b1);
        const size_t off = (size_t)row * N + col;
        if (EPI == EPI_RESIDUAL) {
          const __nv_bfloat162 x =
              *reinterpret_cast<const __nv_bfloat162*>(resid + off);
          float2 s;
          s.x = v0 + __bfloat162float(x.x);
          s.y = v1 + __bfloat162float(x.y);
          *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = s;
        } else {
          if (EPI == EPI_GELU) {
            v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
            v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
          }
          *reinterpret_cast<unsigned*>(static_cast<bf16*>(out) + off) =
              pack_bf16x2(v0, v1);
        }
      }
    }
  }
}

template <int EPI>
int launch(const void* a, const void* w, const float* bias, const void* resid,
           void* out, int M, int N, int K, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_kernel<EPI><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w), bias,
      static_cast<const bf16*>(resid), out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (M, N) bf16 = act(bf16(a (M, K) @ w (K, N) + bias)); act 0 = none,
// 1 = erf-GELU.  Requires N % 128 == 0, K % 32 == 0.
int nbk_gemm_bias_act(const void* a, const void* w, const float* bias,
                      void* out, int M, int N, int K, int act,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act == 1)
    return launch<EPI_GELU>(a, w, bias, nullptr, out, M, N, K, s);
  return launch<EPI_NONE>(a, w, bias, nullptr, out, M, N, K, s);
}

// out (M, N) f32 = f32(bf16(a @ w + bias)) + f32(resid (M, N) bf16).
int nbk_gemm_bias_residual(const void* a, const void* w, const float* bias,
                           const void* resid, float* out, int M, int N, int K,
                           void* stream) {
  return launch<EPI_RESIDUAL>(a, w, bias, resid, out, M, N, K,
                              static_cast<cudaStream_t>(stream));
}

const char* nbk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
