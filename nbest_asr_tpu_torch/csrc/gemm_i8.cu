// The int8 residual GEMM, gemm_i8_bias_residual: the out-proj and W2
// products of the int8 serving and int8 training layers, with a
// dequantizing, dropout and residual-sum epilogue.  The other int8
// products (gemm_i8_bias_act, gemm_i8_dgrad) run on the wgmma + TMA kernel
// of gemm_wgmma.cu; this one keeps its mma.sync kernel until it is
// redesigned the same way.
//
// Replaces `_dense_i8` / `_dot_i8` (nbest_asr_tpu/ops/int8_serving.py:66-79)
// inside the two TPU int8 serving megakernels:
//   _attn_i8_kernel (:157) -- out-proj (:191-193)  -> gemm_i8_bias_residual
//   _ffn_i8_kernel (:90)   -- W2 (:96-97)          -> gemm_i8_bias_residual
// and the `_dense_i8_f32` / `_dense_rows_i8` GEMMs of the int8 training
// forwards
//   nbest_asr_tpu/ops/fused_ffn.py:_fwd_kernel_i8 (:404)
//     - W2, bf16, drop 2, y2d (:424-431)    -> gemm_i8_bias_residual, y2d
//                                              saved
//   nbest_asr_tpu/ops/fused_attention.py:_fab_fwd_kernel_i8 (:436)
//     - out-proj, bf16, hidden drop, od (:471-478)
//                                           -> gemm_i8_bias_residual, od saved
// The TPU kernels hold the int8 weights resident in VMEM (4.7 MB for the
// FFN pair); here the GEMM streams 128x64 int8 tiles of the quantized
// activations and of the weights through a 4-stage cp.async ring and keeps
// its 128x128 s32 accumulator tile in registers.
//
// Operands: A (M, K) int8 row-major, the per-token quantized activations
// (quant_rows.cu) with their (M,) f32 scales; Wt (N, K) int8 row-major, so
// that each output column's weights are K-contiguous as mma .row.col wants
// them (ldmatrix.trans moves 16-bit elements and cannot transpose int8):
// the (K, N) JAX-layout weight stored column-major, with (N,) f32
// per-output-channel scales.  mma.sync m16n8k32 s8 x s8 -> s32.
//
// What bounds it on the H100: in serving at BERT-base shapes the GEMM sits
// above the int8 ridge, so tensor-core issue rate bounds it; in training
// at 8192 rows the bytes of its epilogue do.  The Philox dropout bits cost
// one 10-round call per pair of output columns in the epilogue.
//
// Epilogue numerics follow the TPU kernels exactly: the dequant is
// ((f32(acc) * x_scale) * w_scale) + bias, each operation rounded
// (__fmul_rn / __fadd_rn, so nvcc cannot contract them into an FMA), ONE
// bf16 rounding, then y2 = drop(f32 h) (stream 2 or 4); [bf16(y2) saved as
// y2d / od]; store y2 + f32(residual) as f32, the input of the row
// LayerNorm kernel (layer_norm.cu).  The integer dot is exact (|acc| <=
// 127^2 * K < 2^31 for K <= 133,000), so the kernel equals its plain
// version bit for bit.
#include "common.cuh"
#include "philox.cuh"

namespace {

using namespace nbk;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4, THREADS = 256;
constexpr int LD = BK + 16;  // 80-byte rows: 16-B aligned, ldmatrix
                             // conflict-free
constexpr int A_STAGE = BM * LD;  // bytes
constexpr int B_STAGE = BN * LD;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE);

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

// The epilogue of output columns (col, col + 1) of ``row``; ws / b are the
// two columns' weight scales and biases.  TRAIN compiles in the Philox
// dropout (drop.on) and the saved residual (aux): the serving instance is
// built without them (with both compiled into every instance the serving
// GEMMs ran 13-40% slower on the H100).  The pointers are the kernel's
// __restrict__ arguments (from a struct without it, the loads had to wait
// for the stores before them: 20% slower).
template <bool TRAIN>
__device__ __forceinline__ void epilogue_pair(
    const float* __restrict__ x_scale, const bf16* __restrict__ resid,
    bf16* __restrict__ aux, float* __restrict__ out, const DropParams& drop,
    int row, int col, int N, int a0, int a1, float ws0, float ws1, float b0,
    float b1) {
  const size_t off = (size_t)row * N + col;
  const float xs = x_scale[row];
  unsigned bits0 = 0xFFFFFFFFu, bits1 = 0xFFFFFFFFu;
  const bool dropping = TRAIN && drop.on;
  if (dropping) {  // col is even: both columns lie in one Philox group
    const uint4 w = philox_group(drop, row, col);
    bits0 = (col & 2) ? w.z : w.x;
    bits1 = (col & 2) ? w.w : w.y;
  }
  float v0 = round_bf16(dequant(a0, xs, ws0, b0));
  float v1 = round_bf16(dequant(a1, xs, ws1, b1));
  if (dropping) {
    v0 = drop_value(drop, v0, bits0);
    v1 = drop_value(drop, v1, bits1);
  }
  if (TRAIN && aux)
    *reinterpret_cast<unsigned*>(aux + off) = pack_bf16x2(v0, v1);
  const __nv_bfloat162 x =
      *reinterpret_cast<const __nv_bfloat162*>(resid + off);
  float2 s;
  s.x = __fadd_rn(v0, __bfloat162float(x.x));
  s.y = __fadd_rn(v1, __bfloat162float(x.y));
  *reinterpret_cast<float2*>(out + off) = s;
}

// Built for 2 blocks per SM (128 registers).
template <bool TRAIN>
__global__ void __launch_bounds__(THREADS, 2)
    gemm_i8_kernel(const int8_t* __restrict__ A,
                   const int8_t* __restrict__ Wt,
                   const float* __restrict__ x_scale,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ bias,
                   const bf16* __restrict__ resid, bf16* __restrict__ aux,
                   float* __restrict__ out, const DropParams drop, int M,
                   int N, int K) {
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
        epilogue_pair<TRAIN>(x_scale, resid, aux, out, drop, row, col, N,
                             acc[mi][ni][2 * half],
                             acc[mi][ni][2 * half + 1], ws0, ws1, b0, b1);
      }
    }
  }
}

template <bool TRAIN>
int launch(const void* a, const void* wt, const float* x_scale,
           const float* w_scale, const float* bias, const bf16* resid,
           bf16* aux, float* out, const DropParams& drop, int M, int N,
           int K, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_i8_kernel<TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_i8_kernel<TRAIN><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(wt),
      x_scale, w_scale, bias, resid, aux, out, drop, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (M, N) f32 = y2 + f32(resid (M, N) bf16), y2 = drop(f32(bf16(dequant(
// a . wt) + bias))); y2d_out (M, N) bf16, if not null, receives bf16(y2).
// Requires N % 128 == 0, K % 64 == 0.
int nbk_gemm_i8_bias_residual(const void* a, const float* x_scale,
                              const void* wt, const float* w_scale,
                              const float* bias, const void* resid,
                              float* out, void* y2d_out, int M, int N, int K,
                              unsigned long long seed, int stream,
                              unsigned thresh, float inv_keep, int drop_on,
                              void* cuda_stream) {
  const DropParams d = make_drop(seed, stream, thresh, inv_keep, drop_on);
  const bf16* r = static_cast<const bf16*>(resid);
  bf16* aux = static_cast<bf16*>(y2d_out);
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  // the training instance where a dropout or a saved residual is asked for
  return d.on || aux
             ? launch<true>(a, wt, x_scale, w_scale, bias, r, aux, out, d, M,
                            N, K, s)
             : launch<false>(a, wt, x_scale, w_scale, bias, r, aux, out, d,
                             M, N, K, s);
}

}  // extern "C"
