// Tensor-core GEMMs with fused epilogues on the mma.sync mainloop: the
// QKV and FFN-in weight products of an encoder layer's forward.  (The
// out-projection, FFN-out and the backwards' dgrads run on the wgmma + TMA
// mainloop of gemm_wgmma.cu; this one goes there next.)
//
// Replaces the in-kernel GEMMs of the TPU megakernels:
//   nbest_asr_tpu/ops/fused_attention.py:_fab_fwd_kernel (:152)
//     - `_qkv_gemm` (:143)            -> gemm_bias_act, act = none
//   nbest_asr_tpu/ops/fused_ffn.py:_fwd_kernel (:166)
//     - `_gelu_slice` (:153)          -> gemm_bias_act, act = erf-GELU,
//                                        dropout 1, h saved
// The TPU kernels hold both weight matrices resident in VMEM (9.4 MB for
// the FFN pair); an SM has 227 KB of shared memory, so here each GEMM
// streams 128x32 / 32x128 bf16 tiles of A and W through a 3-stage
// cp.async ring and keeps its 128x128 f32 accumulator tile in registers.
//
// What bounds it on the H100: at BERT-base shapes (M = 8192 rows, K = 768,
// N in {2304, 3072}) both GEMMs sit far above the bf16 ridge (~295
// flop/byte), so tensor-core issue rate bounds them.  This version uses
// mma.sync (the sm_80 path, roughly two thirds of Hopper's wgmma peak at
// best) with ldmatrix fragment loads from padded, conflict-free shared
// tiles.  The Philox dropout bits cost one 10-round call per pair of output
// columns in the epilogue.
//
// Epilogue numerics follow the TPU kernels exactly, with __fmul_rn /
// __fadd_rn where nvcc could otherwise contract a multiply-add:
//   act none  : bf16(acc + bias)
//   act gelu  : h = bf16(acc + bias); [h saved]; g = gelu_erf(f32 h) in
//               f32 (erff, exact erf -- not the TPU's A&S polynomial);
//               g = drop1(g) (times f32(1/keep)); store bf16(g)
#include "common.cuh"
#include "philox.cuh"

namespace {

using namespace nbk;

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int A_LD = BK + 8;  // 80-byte rows: 16-B aligned, ldmatrix
constexpr int B_LD = BN + 8;  // 272-byte rows    conflict-free
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;  // W (K, N) row-major: 32 x 128 tiles
constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * 2;

enum { EPI_NONE = 0, EPI_GELU = 1 };

struct Epi {
  const float* bias;  // (N,) f32
  bf16* aux;          // gelu: h out
  bf16* out;
  DropParams drop;
};

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
  // W tile, 32 k-rows x 128 n-cols of W (K, N) (N % 128 == 0 and
  // K % 32 == 0 are checked by the wrapper)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 4, col = (c & 15) * 8;
    cp_async_16(sB + r * B_LD + col, W + (size_t)(k0 + r) * N + n0 + col,
                true);
  }
}

template <int EPI>
__device__ __forceinline__ void epilogue_pair(const Epi& e, int row, int col,
                                              int N, float a0, float a1) {
  const size_t off = (size_t)row * N + col;
  unsigned bits0 = 0xFFFFFFFFu, bits1 = 0xFFFFFFFFu;
  if (e.drop.on) {  // col is even: both columns lie in one Philox group
    const uint4 w = philox_group(e.drop, row, col);
    bits0 = (col & 2) ? w.z : w.x;
    bits1 = (col & 2) ? w.w : w.y;
  }
  float v0 = round_bf16(a0 + e.bias[col]);
  float v1 = round_bf16(a1 + e.bias[col + 1]);
  if (EPI == EPI_GELU) {
    if (e.aux)  // v is bf16-exact: h as the TPU kernel rounds it
      *reinterpret_cast<unsigned*>(e.aux + off) = pack_bf16x2(v0, v1);
    v0 = gelu_f32(v0);
    v1 = gelu_f32(v1);
    if (e.drop.on) {
      v0 = drop_value(e.drop, v0, bits0);
      v1 = drop_value(e.drop, v1, bits1);
    }
  }
  *reinterpret_cast<unsigned*>(e.out + off) = pack_bf16x2(v0, v1);
}

template <int EPI>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                const Epi e, int M, int N, int K) {
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
        // W tile is (k, n): transposed 8x8 loads give B fragments;
        // matrices = (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
        // (k 8-15, n 8-15) -> b0,b1 of n-tile 2nj and of 2nj+1
        unsigned t[4];
        const int r = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = wn * 32 + nj * 16 + (lane >> 4) * 8;
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
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (row >= M) continue;
        epilogue_pair<EPI>(e, row, col, N, acc[mi][ni][2 * half],
                           acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

template <int EPI>
int launch(const void* a, const void* w, const Epi& e, int M, int N, int K,
           cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_kernel<EPI><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w), e, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (M, N) bf16 = act(bf16(a (M, K) @ w (K, N) + bias)); act 0 = none,
// 1 = erf-GELU followed by Philox dropout when drop_on (stream, thresh,
// inv_keep as in philox.cuh).  h_out (M, N) bf16, if not null, receives
// bf16(a @ w + bias) before the GELU.  Requires N % 128 == 0, K % 32 == 0.
int nbk_gemm_bias_act(const void* a, const void* w, const float* bias,
                      void* out, void* h_out, int M, int N, int K, int act,
                      unsigned long long seed, int stream, unsigned thresh,
                      float inv_keep, int drop_on, void* cuda_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  Epi e = {};
  e.bias = bias;
  e.aux = static_cast<bf16*>(h_out);
  e.out = static_cast<bf16*>(out);
  e.drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  if (act == 1) return launch<EPI_GELU>(a, w, e, M, N, K, s);
  return launch<EPI_NONE>(a, w, e, M, N, K, s);
}

const char* nbk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
