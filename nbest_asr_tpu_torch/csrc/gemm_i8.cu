// Int8 tensor-core GEMMs with dequantizing epilogues: the four weight
// products of an encoder layer on the int8 serving path.
//
// Replaces `_dense_i8` / `_dot_i8` (nbest_asr_tpu/ops/int8_serving.py:66-79)
// inside the two TPU int8 serving megakernels:
//   _attn_i8_kernel (:157) -- QKV (:168)           -> gemm_i8_bias_act, none
//                          -- out-proj (:191-193)  -> gemm_i8_bias_residual
//   _ffn_i8_kernel (:90)   -- W1 + GELU (:94-95)   -> gemm_i8_bias_act, gelu
//                          -- W2 (:96-97)          -> gemm_i8_bias_residual
// The TPU kernels hold the int8 weights resident in VMEM (4.7 MB for the
// FFN pair); here each GEMM streams 128x64 int8 tiles of the quantized
// activations and of the weights through a 4-stage cp.async ring and keeps
// its 128x128 s32 accumulator tile in registers.
//
// Operands: A (M, K) int8 row-major, the per-token quantized activations
// (quant_rows.cu) with their (M,) f32 scales; Wt (N, K) int8 row-major,
// i.e. the (K, N) JAX-layout weight stored column-major, so that each
// output column's weights are K-contiguous as mma .row.col wants them
// (ldmatrix.trans moves 16-bit elements and cannot transpose int8), with
// (N,) f32 per-output-channel scales.  mma.sync m16n8k32 s8 x s8 -> s32.
//
// What bounds it on the H100: at BERT-base shapes the GEMMs sit far above
// the int8 ridge, so tensor-core issue rate bounds them.  This first
// version uses mma.sync (sm_80 instructions); wgmma with s8 and TMA is
// later work.
//
// Epilogue numerics follow int8_serving.py:78-79 and quant.py:92-93
// exactly: ((f32(acc) * x_scale) * w_scale) + bias, each operation
// rounded (__fmul_rn / __fadd_rn, so nvcc cannot contract them into an
// FMA), ONE bf16 rounding, then
//   act none : store bf16
//   act gelu : gelu_erf in f32 on the rounded value (erff), store bf16
//   residual : store f32(bf16 result) + f32(residual) as f32, the input of
//              the row LayerNorm kernel (layer_norm.cu)
// The integer dot is exact (|acc| <= 127^2 * K < 2^31 for K <= 133,000),
// so the kernel equals its plain version bit for bit, up to erff in the
// GELU epilogue.
#include "common.cuh"

namespace {

using namespace nbk;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4, THREADS = 256;
constexpr int LD = BK + 16;  // 80-byte rows: 16-B aligned, ldmatrix
                             // conflict-free
constexpr int A_STAGE = BM * LD;  // bytes
constexpr int B_STAGE = BN * LD;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE);

enum { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

// d += a * b, s8 inputs, s32 accumulation.  Fragments (g = lane / 4,
// t = lane % 4; each register holds 4 consecutive k):
//   A (16x32): a0 = (g, 4t..), a1 = (g+8, 4t..), a2 = (g, 16+4t..),
//              a3 = (g+8, 16+4t..)
//   B (32x8):  b0 = (k 4t.., n g), b1 = (k 16+4t.., n g)
//   C (16x8):  c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void load_stage(int8_t* sA, int8_t* sB,
                                           const int8_t* __restrict__ A,
                                           const int8_t* __restrict__ Wt,
                                           int M, int K, int m0, int n0,
                                           int k0, int tid) {
  // 128 rows x 64 bytes = 512 chunks of 16 bytes per operand, two per
  // thread; A rows past M are zero-filled.  N % 128 == 0 and K % 64 == 0
  // are checked by the wrapper.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 2, col = (c & 3) * 16;
    const int gr = m0 + r;
    const bool ok = gr < M;
    cp_async_16(sA + r * LD + col, A + (size_t)(ok ? gr : 0) * K + k0 + col,
                ok);
    cp_async_16(sB + r * LD + col, Wt + (size_t)(n0 + r) * K + k0 + col,
                true);
  }
}

__device__ __forceinline__ float dequant(int acc, float xs, float ws,
                                         float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws), b);
}

template <int EPI>
__global__ void __launch_bounds__(THREADS)
    gemm_i8_kernel(const int8_t* __restrict__ A,
                   const float* __restrict__ x_scale,
                   const int8_t* __restrict__ Wt,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ bias,
                   const bf16* __restrict__ resid, void* __restrict__ out,
                   int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* sB = sA + STAGES * A_STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2;  // 64-row half of the block tile
  const int wn = warp & 3;   // 32-col quarter
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = K / BK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage(sA + s * A_STAGE, sB + s * B_STAGE, A, Wt, M, K, m0, n0,
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
                 A, Wt, M, K, m0, n0, nk * BK, tid);
    cp_async_commit();

    const int8_t* a = sA + (kt % STAGES) * A_STAGE;
    const int8_t* b = sB + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[4][4], bfr[4][2];
      // ldmatrix moves 8 rows x 16 bytes per matrix; lane i receives
      // bytes 4(i%4).. of row i/4, which is the s8 fragment layout above.
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // matrices (rows 0-7, k 0-15), (8-15, 0-15), (0-7, 16-31),
        // (8-15, 16-31) -> a0..a3
        const int r = wm * 64 + mi * 16 + (lane & 15);
        const int c = kk + (lane >> 4) * 16;
        ldmatrix_x4(af[mi], a + r * LD + c);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // Wt rows are output columns: matrices (n 0-7, k 0-15),
        // (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31) ->
        // b0, b1 of n-tile 2nj and of 2nj+1
        const int j = lane >> 3;
        const int r = wn * 32 + nj * 16 + (lane & 7) + (j >> 1) * 8;
        const int c = kk + (j & 1) * 16;
        unsigned t[4];
        ldmatrix_x4(t, b + r * LD + c);
        bfr[2 * nj][0] = t[0];
        bfr[2 * nj][1] = t[1];
        bfr[2 * nj + 1][0] = t[2];
        bfr[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
    const float ws0 = w_scale[col], ws1 = w_scale[col + 1];
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (row >= M) continue;
        const float xs = x_scale[row];
        float v0 = round_bf16(dequant(acc[mi][ni][2 * half], xs, ws0, b0));
        float v1 =
            round_bf16(dequant(acc[mi][ni][2 * half + 1], xs, ws1, b1));
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
int launch(const void* a, const float* xs, const void* wt, const float* ws,
           const float* bias, const void* resid, void* out, int M, int N,
           int K, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_i8_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_i8_kernel<EPI><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(a), xs, static_cast<const int8_t*>(wt), ws,
      bias, static_cast<const bf16*>(resid), out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (M, N) bf16 = act(bf16(dequant(a (M, K) s8 . wt (N, K) s8) + bias));
// act 0 = none, 1 = erf-GELU.  Requires N % 128 == 0, K % 64 == 0.
int nbk_gemm_i8_bias_act(const void* a, const float* x_scale, const void* wt,
                         const float* w_scale, const float* bias, void* out,
                         int M, int N, int K, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act == 1)
    return launch<EPI_GELU>(a, x_scale, wt, w_scale, bias, nullptr, out, M,
                            N, K, s);
  return launch<EPI_NONE>(a, x_scale, wt, w_scale, bias, nullptr, out, M, N,
                          K, s);
}

// out (M, N) f32 = f32(bf16(dequant(a . wt) + bias)) + f32(resid (M, N)
// bf16).
int nbk_gemm_i8_bias_residual(const void* a, const float* x_scale,
                              const void* wt, const float* w_scale,
                              const float* bias, const void* resid,
                              float* out, int M, int N, int K,
                              void* stream) {
  return launch<EPI_RESIDUAL>(a, x_scale, wt, w_scale, bias, resid, out, M, N,
                              K, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
