// Tensor-core GEMMs with fused epilogues: the weight products of an
// encoder layer's forward (QKV, attention out-projection, FFN-in,
// FFN-out) and the dgrad products of the two blocks' backwards.
//
// Replaces the in-kernel GEMMs of the TPU megakernels:
//   nbest_asr_tpu/ops/fused_attention.py:_fab_fwd_kernel (:152)
//     - `_qkv_gemm` (:143)            -> gemm_bias_act, act = none
//     - out-proj `ctx @ wo + bo` (:182) -> gemm_bias_residual
//   nbest_asr_tpu/ops/fused_ffn.py:_fwd_kernel (:166)
//     - `_gelu_slice` (:153)          -> gemm_bias_act, act = erf-GELU,
//                                        dropout 1, h saved
//     - `gd @ w2 + b2` (:181-191)      -> gemm_bias_residual, dropout 2,
//                                        y2d saved
//   nbest_asr_tpu/ops/fused_ffn.py:_bwd_kernel (:224)
//     - `dy2 @ w2^T`, drop 1, * gelu'(h) (:245-253) -> gemm_dgrad dgelu
//     - `ds + dh @ w1^T` (:239, :251, :258)          -> gemm_dgrad residual
//   nbest_asr_tpu/ops/fused_attention.py:_fab_bwd_kernel (:204)
//     - dctx = `dout @ wo^T` (:232, bf16 per head :243) -> gemm_dgrad none
//     - `ds + dqkv @ wqkv^T` (:268-269)                 -> gemm_dgrad residual
// The TPU kernels hold both weight matrices resident in VMEM (9.4 MB for
// the FFN pair); an SM has 227 KB of shared memory, so here each GEMM
// streams 128x32 / 32x128 bf16 tiles of A and W through a 3-stage
// cp.async ring and keeps its 128x128 f32 accumulator tile in registers.
// The dgrad GEMMs multiply by a transposed weight: they read W (N, K)
// row-major, K-contiguous per output column, which is the B fragment's own
// order, so ldmatrix loads it without .trans and no transposed copy of a
// weight is ever made (the "NT" load path below).
//
// What bounds it on the H100: at BERT-base shapes (M = 8192 rows, K, N in
// {768, 2304, 3072}) every GEMM sits far above the bf16 ridge (~295
// flop/byte), so tensor-core issue rate bounds it.  This first version
// uses mma.sync (the sm_80 path, roughly two thirds of Hopper's wgmma peak
// at best) with ldmatrix fragment loads from padded, conflict-free shared
// tiles; wgmma + TMA is later work.  The Philox dropout bits cost one
// 10-round call per pair of output columns in the epilogue.
//
// Epilogue numerics follow the TPU kernels exactly, with __fmul_rn /
// __fadd_rn where nvcc could otherwise contract a multiply-add:
//   act none  : bf16(acc + bias)
//   act gelu  : h = bf16(acc + bias); [h saved]; g = gelu_erf(f32 h) in
//               f32 (erff, exact erf -- not the TPU's A&S polynomial);
//               g = drop1(g) (times f32(1/keep)); store bf16(g)
//   residual  : y2 = f32(bf16(acc + bias)); y2 = drop2(y2); [bf16(y2)
//               saved as y2d]; store y2 + f32(resid) as f32, the input of
//               the row LayerNorm kernel (layer_norm.cu) -- the sum uses
//               the unrounded f32 y2, as the TPU kernel does
//   dgelu     : d = drop1(acc); dh = bf16(d * gelu'(f32 h)); [gd =
//               bf16(drop1(gelu(f32 h))) regenerated and saved for dW2]
//   dx        : bf16(ds + acc), ds the f32 residual-branch gradient
//   dnone     : bf16(acc)
#include "common.cuh"
#include "philox.cuh"

namespace {

using namespace nbk;

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int A_LD = BK + 8;  // 80-byte rows: 16-B aligned, ldmatrix
constexpr int B_LD = BN + 8;  // 272-byte rows    conflict-free
constexpr int A_STAGE = BM * A_LD;

// W (K, N) row-major: 32 x 128 tiles; W (N, K) row-major ("NT"): 128 x 32
template <bool NT>
struct BTile {
  static constexpr int LD = NT ? BK + 8 : B_LD;
  static constexpr int STAGE = NT ? BN * (BK + 8) : BK * B_LD;
  static constexpr int SMEM = STAGES * (A_STAGE + STAGE) * 2;
};

enum { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2, EPI_DGELU = 3,
       EPI_DX = 4, EPI_DNONE = 5 };

struct Epi {
  const float* bias;  // (N,) f32; null for the dgrads
  const bf16* resid;  // residual: (M, N) bf16 block input
  const float* addf;  // dx: (M, N) f32 residual-branch gradient
  const bf16* h;      // dgelu: (M, N) bf16 pre-GELU activations
  bf16* aux;          // gelu: h out; residual: y2d out; dgelu: gd out
  void* out;
  DropParams drop;
};

template <bool NT>
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
  // W tile (N % 128 == 0 and K % 32 == 0 are checked by the wrapper)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    if (NT) {  // 128 n-rows x 32 k-cols of W (N, K)
      const int r = c >> 2, col = (c & 3) * 8;
      cp_async_16(sB + r * BTile<NT>::LD + col,
                  W + (size_t)(n0 + r) * K + k0 + col, true);
    } else {   // 32 k-rows x 128 n-cols of W (K, N)
      const int r = c >> 4, col = (c & 15) * 8;
      cp_async_16(sB + r * BTile<NT>::LD + col,
                  W + (size_t)(k0 + r) * N + n0 + col, true);
    }
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
  if (EPI == EPI_DNONE) {
    *reinterpret_cast<unsigned*>(static_cast<bf16*>(e.out) + off) =
        pack_bf16x2(a0, a1);
  } else if (EPI == EPI_DX) {
    const float2 r = *reinterpret_cast<const float2*>(e.addf + off);
    *reinterpret_cast<unsigned*>(static_cast<bf16*>(e.out) + off) =
        pack_bf16x2(__fadd_rn(r.x, a0), __fadd_rn(r.y, a1));
  } else if (EPI == EPI_DGELU) {
    float d0 = a0, d1 = a1;
    if (e.drop.on) {
      d0 = drop_value(e.drop, a0, bits0);
      d1 = drop_value(e.drop, a1, bits1);
    }
    const __nv_bfloat162 hh = *reinterpret_cast<const __nv_bfloat162*>(
        e.h + off);
    const float h0 = __bfloat162float(hh.x), h1 = __bfloat162float(hh.y);
    *reinterpret_cast<unsigned*>(static_cast<bf16*>(e.out) + off) =
        pack_bf16x2(__fmul_rn(d0, gelu_grad_f32(h0)),
                    __fmul_rn(d1, gelu_grad_f32(h1)));
    if (e.aux) {
      float g0 = gelu_f32(h0), g1 = gelu_f32(h1);
      if (e.drop.on) {
        g0 = drop_value(e.drop, g0, bits0);
        g1 = drop_value(e.drop, g1, bits1);
      }
      *reinterpret_cast<unsigned*>(e.aux + off) = pack_bf16x2(g0, g1);
    }
  } else {
    float v0 = round_bf16(a0 + e.bias[col]);
    float v1 = round_bf16(a1 + e.bias[col + 1]);
    if (EPI == EPI_RESIDUAL) {
      if (e.drop.on) {
        v0 = drop_value(e.drop, v0, bits0);
        v1 = drop_value(e.drop, v1, bits1);
      }
      if (e.aux)
        *reinterpret_cast<unsigned*>(e.aux + off) = pack_bf16x2(v0, v1);
      const __nv_bfloat162 x =
          *reinterpret_cast<const __nv_bfloat162*>(e.resid + off);
      float2 s;
      s.x = __fadd_rn(v0, __bfloat162float(x.x));
      s.y = __fadd_rn(v1, __bfloat162float(x.y));
      *reinterpret_cast<float2*>(static_cast<float*>(e.out) + off) = s;
    } else {
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
      *reinterpret_cast<unsigned*>(static_cast<bf16*>(e.out) + off) =
          pack_bf16x2(v0, v1);
    }
  }
}

template <int EPI, bool NT>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                const Epi e, int M, int N, int K) {
  using BT = BTile<NT>;
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
      load_stage<NT>(sA + s * A_STAGE, sB + s * BT::STAGE, A, W, M, N, K, m0,
                     n0, s * BK, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the slot consumed in iteration kt-1 (free after the barrier)
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      load_stage<NT>(sA + (nk % STAGES) * A_STAGE,
                     sB + (nk % STAGES) * BT::STAGE, A, W, M, N, K, m0, n0,
                     nk * BK, tid);
    cp_async_commit();

    const bf16* a = sA + (kt % STAGES) * A_STAGE;
    const bf16* b = sB + (kt % STAGES) * BT::STAGE;
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
        unsigned t[4];
        if (NT) {
          // W tile is (n, k): plain 8x8 loads give B fragments directly;
          // matrices = (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
          // (n 8-15, k 8-15) -> b0,b1 of n-tile 2nj and of 2nj+1
          const int r = wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8;
          const int c = kk + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(t, b + r * BT::LD + c);
        } else {
          // W tile is (k, n): transposed 8x8 loads give B fragments;
          // matrices = (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
          // (k 8-15, n 8-15) -> b0,b1 of n-tile 2nj and of 2nj+1
          const int r = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int c = wn * 32 + nj * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(t, b + r * BT::LD + c);
        }
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

template <int EPI, bool NT>
int launch(const void* a, const void* w, const Epi& e, int M, int N, int K,
           cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<EPI, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        BTile<NT>::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_kernel<EPI, NT><<<grid, THREADS, BTile<NT>::SMEM, stream>>>(
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
  e.out = out;
  e.drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  if (act == 1) return launch<EPI_GELU, false>(a, w, e, M, N, K, s);
  return launch<EPI_NONE, false>(a, w, e, M, N, K, s);
}

// out (M, N) f32 = y2 + f32(resid (M, N) bf16), y2 = drop(f32(bf16(a @ w
// + bias))); y2d_out (M, N) bf16, if not null, receives bf16(y2).
int nbk_gemm_bias_residual(const void* a, const void* w, const float* bias,
                           const void* resid, float* out, void* y2d_out,
                           int M, int N, int K, unsigned long long seed,
                           int stream, unsigned thresh, float inv_keep,
                           int drop_on, void* cuda_stream) {
  Epi e = {};
  e.bias = bias;
  e.resid = static_cast<const bf16*>(resid);
  e.aux = static_cast<bf16*>(y2d_out);
  e.out = out;
  e.drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  return launch<EPI_RESIDUAL, false>(a, w, e, M, N, K,
                                     static_cast<cudaStream_t>(cuda_stream));
}

// The backwards' dgrads, a (M, K) @ w^T with w (N, K) row-major:
// epi 0 (dgelu): out = dh (M, N) bf16 = bf16(drop(a @ w^T) * gelu'(h)),
//   h (M, N) bf16; gd_out (M, N) bf16, if not null, receives
//   bf16(drop(gelu(h))).
// epi 1 (residual): out = dx (M, N) bf16 = bf16(ds + a @ w^T), ds (M, N)
//   f32.
// epi 2 (none): out (M, N) bf16 = bf16(a @ w^T).
int nbk_gemm_dgrad(const void* a, const void* w, void* out, const void* h,
                   void* gd_out, const float* ds, int M, int N, int K,
                   int epi, unsigned long long seed, int stream,
                   unsigned thresh, float inv_keep, int drop_on,
                   void* cuda_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  Epi e = {};
  e.h = static_cast<const bf16*>(h);
  e.aux = static_cast<bf16*>(gd_out);
  e.addf = ds;
  e.out = out;
  e.drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  if (epi == 0) return launch<EPI_DGELU, true>(a, w, e, M, N, K, s);
  if (epi == 1) return launch<EPI_DX, true>(a, w, e, M, N, K, s);
  if (epi == 2) return launch<EPI_DNONE, true>(a, w, e, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

const char* nbk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
