// Segment-masked softmax attention per (element, head, 64-query tile),
// reading q, k and v by column offset straight from the (n, 3h) QKV
// buffer and writing ctx (n, h) -- no head transposes.
//
// Replaces the head loop of the TPU attention-block megakernel:
//   nbest_asr_tpu/ops/fused_attention.py:_fab_fwd_kernel (:167-180),
//   through `_head_probs` (:103-126), at dropout rate 0.
// Contract kept: SEGMENT-mask semantics (a query attends exactly the
// keys carrying its own mask value; pads attend pads), masked scores
// filled with MASK_VALUE (-0.7 * FLT_MAX), a PLAIN softmax in f32 over
// the whole row (p = exp(s - max) / sum, seq <= 512), probs rounded to
// bf16 before P.V, f32 accumulation, ctx rounded to bf16.  Keys past the
// sequence end are excluded outright, which is what the TPU wrapper's
// -1 mask padding achieves (fused_attention.py:791-797).
//
// Design: the TPU kernel holds the whole (s, s) score matrix in VMEM.
// Here a warp owns 16 query rows and the row statistics live in
// registers: pass 1 sweeps the key tiles for the row max and sum (the
// sum rescaled as the max grows), pass 2 recomputes the same scores
// bit for bit, normalises them exactly, rounds to bf16 and feeds them
// from registers straight into the P.V tensor-core MMA (the C fragment
// of S is the A fragment of P).  Recomputing QK^T costs one extra
// s*s*d MMA per head -- small beside the layer's GEMMs -- and keeps
// shared memory at three 64-row tiles, so many blocks fit on an SM.
//
// What bounds it on the H100: at s <= 512 the per-head work is a few
// MFLOP on 2*s*d*2 bytes of K and V, so latency of the small tiles and
// the serial tile loop bound it, not HBM or tensor-core rate.
#include <math.h>

#include "common.cuh"

namespace {

using namespace nbk;

constexpr int QT = 64;        // query rows per block (16 per warp)
constexpr int KT = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // padded rows: ldmatrix conflict-free
  static constexpr int TILE = QT * LD;
  static size_t bytes(int S) {
    return (size_t)3 * TILE * sizeof(bf16) + (size_t)S * sizeof(float);
  }
};

// rows [r0, r0 + 64) of one head's q, k or v columns -> shared tile;
// rows past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S, int ld) {
  constexpr int CPR = D / 8;
  for (int c = threadIdx.x; c < QT * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int row = r0 + r;
    const bool ok = row < S;
    cp_async_16(dst + r * Smem<D>::LD + col,
                src + (size_t)(ok ? row : 0) * ld + col, ok);
  }
}

// Scaled, masked scores of this warp's 16 query rows against the 64 keys
// in sK (keys k0 .. k0 + 63).  sc[nt] is the C fragment of keys
// k0 + 8 nt .. + 7.
template <int D>
__device__ __forceinline__ void tile_scores(float (&sc)[8][4],
                                            const unsigned (&qf)[D / 16][4],
                                            const bf16* sK, const float* sM,
                                            int k0, int S, float qma,
                                            float qmb, float sm_scale,
                                            int lane) {
  constexpr int LD = Smem<D>::LD;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[nt][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      // K is (key, d) row-major = B^T: plain 8x8 loads give B fragments;
      // matrices = (keys 0-7, d 0-7), (keys 0-7, d 8-15),
      // (keys 8-15, d 0-7), (keys 8-15, d 8-15)
      unsigned kf[4];
      const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int c = kk * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(kf, sK + r * LD + c);
      mma_bf16(sc[2 * np], qf[kk], kf[0], kf[1]);
      mma_bf16(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
    }
  }
  const int t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + nt * 8 + 2 * t4 + (c & 1);
      const float qm = c < 2 ? qma : qmb;
      const float v = sc[nt][c] * sm_scale;
      sc[nt][c] = k >= S ? -INFINITY : (sM[k] == qm ? v : MASK_VALUE);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    seg_attention_kernel(const bf16* __restrict__ qkv,
                         const float* __restrict__ mask,
                         bf16* __restrict__ ctx, int S, int H,
                         float sm_scale) {
  constexpr int LD = Smem<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + Smem<D>::TILE;
  bf16* sV = sK + Smem<D>::TILE;
  float* sM = reinterpret_cast<float*>(sV + Smem<D>::TILE);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QT, head = blockIdx.y, elem = blockIdx.z;
  const size_t row0 = (size_t)elem * S;
  const int ld = 3 * H;
  const bf16* q_src = qkv + row0 * ld + head * D;
  const bf16* k_src = q_src + H;
  const bf16* v_src = q_src + 2 * H;

  for (int j = threadIdx.x; j < S; j += THREADS) sM[j] = mask[row0 + j];
  load_tile<D>(sQ, q_src, q0, S, ld);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  unsigned qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk],
                sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  const int g = lane >> 2, t4 = lane & 3;
  const int qa = q0 + warp * 16 + g, qb = qa + 8;
  // a query row past S matches no key (NaN == x is false); its output
  // is never stored
  const float qma = qa < S ? sM[qa] : __int_as_float(0x7fc00000);
  const float qmb = qb < S ? sM[qb] : __int_as_float(0x7fc00000);
  const int n_kt = (S + KT - 1) / KT;

  // pass 1: row max and sum over every key tile
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<D>(sK, k_src, kt * KT, S, ld);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float sc[8][4];
    tile_scores<D>(sc, qf, sK, sM, kt * KT, S, qma, qmb, sm_scale, lane);
    float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      ta = fmaxf(ta, fmaxf(sc[nt][0], sc[nt][1]));
      tb = fmaxf(tb, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      ta = fmaxf(ta, __shfl_xor_sync(0xffffffffu, ta, o));
      tb = fmaxf(tb, __shfl_xor_sync(0xffffffffu, tb, o));
    }
    // the first tile always holds key 0, so na and nb are finite here
    const float na = fmaxf(ma, ta), nb = fmaxf(mb, tb);
    la *= expf(ma - na);
    lb *= expf(mb - nb);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      la += expf(sc[nt][0] - na) + expf(sc[nt][1] - na);
      lb += expf(sc[nt][2] - nb) + expf(sc[nt][3] - nb);
    }
    ma = na;
    mb = nb;
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, o);
    lb += __shfl_xor_sync(0xffffffffu, lb, o);
  }

  // pass 2: the same scores, normalised, rounded to bf16, times V
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<D>(sK, k_src, kt * KT, S, ld);
    load_tile<D>(sV, v_src, kt * KT, S, ld);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float sc[8][4];
    tile_scores<D>(sc, qf, sK, sM, kt * KT, S, qma, qmb, sm_scale, lane);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      unsigned pa[4];
      pa[0] = pack_bf16x2(expf(sc[2 * ks][0] - ma) / la,
                          expf(sc[2 * ks][1] - ma) / la);
      pa[1] = pack_bf16x2(expf(sc[2 * ks][2] - mb) / lb,
                          expf(sc[2 * ks][3] - mb) / lb);
      pa[2] = pack_bf16x2(expf(sc[2 * ks + 1][0] - ma) / la,
                          expf(sc[2 * ks + 1][1] - ma) / la);
      pa[3] = pack_bf16x2(expf(sc[2 * ks + 1][2] - mb) / lb,
                          expf(sc[2 * ks + 1][3] - mb) / lb);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        // V is (key, d) row-major = B: transposed 8x8 loads;
        // matrices = (keys 0-7, d 0-7), (keys 8-15, d 0-7),
        // (keys 0-7, d 8-15), (keys 8-15, d 8-15)
        unsigned vf[4];
        const int r = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = dp * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(vf, sV + r * LD + c);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = head * D + dt * 8 + 2 * t4;
    if (qa < S)
      *reinterpret_cast<unsigned*>(ctx + (row0 + qa) * H + col) =
          pack_bf16x2(acc[dt][0], acc[dt][1]);
    if (qb < S)
      *reinterpret_cast<unsigned*>(ctx + (row0 + qb) * H + col) =
          pack_bf16x2(acc[dt][2], acc[dt][3]);
  }
}

template <int D>
int launch(const void* qkv, const float* mask, void* ctx, int B, int S, int H,
           int n_heads, float sm_scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes(S);
  cudaError_t e = cudaFuncSetAttribute(
      seg_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + QT - 1) / QT, n_heads, B);
  seg_attention_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), mask, static_cast<bf16*>(ctx), S, H,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (B*S, 3H) bf16 with q | k | v on the column axis, mask (B, S) f32
// segment ids -> ctx (B*S, H) bf16.  Head dim H / n_heads in {64, 128},
// S <= 512.
int nbk_seg_attention(const void* qkv, const float* mask, void* ctx, int B,
                      int S, int H, int n_heads, float sm_scale,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = H / n_heads;
  if (d == 64) return launch<64>(qkv, mask, ctx, B, S, H, n_heads, sm_scale, s);
  if (d == 128)
    return launch<128>(qkv, mask, ctx, B, S, H, n_heads, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
