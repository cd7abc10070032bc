// The chunked attention family: the single-block and tiled attention at
// every head dim the fixed-width instances do not take -- d > 256, and
// any d with d % 8 != 0, whose heads start off the 16-byte boundaries the
// other instances' tile copies need.
//
// Replaces, at those head dims, the head loops of the TPU attention
// kernels:
//   nbest_asr_tpu/ops/fused_attention.py:_fab_fwd_kernel (:152) and
//   _fab_bwd_kernel (:204), _fab_fwd_kernel_i8 (:436) and
//   _fab_bwd_kernel_i8 (:565), int8_serving.py:_attn_i8_kernel (:157),
//   flash_attention.py:_sb_fwd_kernel (:364), _sb_bwd_kernel (:380),
//   _fwd_kernel (:99), _bwd_dkv_kernel (:226) and _bwd_dq_kernel (:276),
// none of which has a head-dim limit in JAX.
//
// Three kernels, each serving both wrapper contracts (ops/kernels.py):
//   chunked_fwd     the single-block forward (probs normalised, then
//                   dropped and rounded to bf16; each row's max and sum
//                   of exp written) or the tiled one (exp(s - m) dropped
//                   and rounded, o scaled by 1 / l; lse = m + log(l))
//   chunked_bwd_dq  dq, and di: rowsum(dp * p) over the keys (single-
//                   block) or rowsum(dO * O) in its prologue (tiled)
//   chunked_bwd_dkv dk and dv, from di
// with the arithmetic of the plain versions (kernels.py:
// sb_attention_reference, flash_fwd_reference, ...): the forward's
// statistics come from a first sweep over the keys, so both contracts
// see the final max, as the plain versions do.
//
// The head dim goes in 64-column chunks, so registers and shared memory
// do not grow with d and no ceiling on d remains: a block holds one
// 64-row tile of each operand's current chunk (cp.async, rows past S and
// columns past d zero-filled), a warp 16 rows, and per 64-key tile a
// thread keeps 32 score (and 32 dP) accumulators and 32 output
// accumulators of one 64-column output chunk.  A score accumulates over
// the head's chunks in one fixed order of k16 steps (chunk_scores), in
// every kernel and every pass -- the dK/dV kernel issues the same
// products with the keys as rows -- so the forward's probs, each output
// chunk's and the backward's rebuilt ones are the same bits.  The output
// chunks are taken one at a time, each recomputing the scores: about
// ceil(d / 64) + 1 score products against the function's one.  k16 steps
// and output columns wholly past d are skipped.
//
// Any alignment: a head's first column is d * head elements into a row,
// so at d % 8 != 0 it leaves the 16-byte boundaries; the copies go at the
// widest width (16, 8, 4 or 2 bytes) that every operand's address, row
// stride and d allow (the launch computes it), and the stores write two
// bf16 at a time where the address allows, else one.
//
// The prob dropout is Philox stream 3 at row (elem * n_heads + head) * S
// + q, column k (attention.cuh, build_keep: per 64 x 64 tile, into
// shared memory), the mask every other attention instance draws.  Each
// pass over queries and keys is ordered: a block owns its query (or key)
// rows and writes each output once, so there are no atomics.
#include <stdint.h>

#include <initializer_list>

#include "attention.cuh"
#include "attention_chunked.cuh"

namespace {

using namespace nbk;
using namespace nbk::attn;

constexpr int CW = 64;                    // columns of a head-dim chunk
constexpr int LDC = Tile<CW>::LD;         // padded row of a shared tile
constexpr int CELEMS = Tile<CW>::ELEMS;   // elements of a shared tile
constexpr int KWORDS = 2;                 // keep words per row of a tile
constexpr int KSTRIDE = 3;                // odd: 8 rows in 8 banks

long long chunked_launches[3] = {0, 0, 0};  // fwd, bwd_dq, bwd_dkv

__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem,
                                           bool pred) {
  const int n = pred ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(n));
}

// Rows r0 .. r0 + 63, head columns c0 .. c0 + 63 of src (row 0, column 0
// of one head; row stride ld) -> a shared tile; rows past S and columns
// past dh are zero-filled.  Copies of 2^lv elements (lv = 3, 2, 1, 0),
// which divide dh, ld and src's offset.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src,
                                           int r0, int S, int ld, int c0,
                                           int dh, int lv) {
  const int shift = 6 - lv;  // log2 of the copies a row
  for (int i = threadIdx.x; i < (ROWS << shift); i += THREADS) {
    const int r = i >> shift, col = (i & ((1 << shift) - 1)) << lv;
    const int row = r0 + r, hc = c0 + col;
    const bool ok = row < S && hc < dh;
    const bf16* g = src + (ok ? (size_t)row * ld + hc : 0);
    bf16* s = dst + r * LDC + col;
    if (lv == 3)
      cp_async_16(s, g, ok);
    else if (lv == 2)
      cp_async_8(s, g, ok);
    else if (lv == 1)
      cp_async_4(s, g, ok);
    else
      *s = ok ? *g : __float2bfloat16_rn(0.f);
  }
}

// sc += the warp's 16 rows of the shared chunk at a (A operand) against
// the 64 rows of the shared chunk x: the first nkk k16 steps (the rest
// are columns past d), in column order.
__device__ __forceinline__ void chunk_scores(float (&sc)[8][4], const bf16* a,
                                             const bf16* x, int nkk,
                                             int lane) {
  unsigned af[CW / 16][4];
  load_a<CW>(af, a, lane);
#pragma unroll
  for (int kk = 0; kk < CW / 16; ++kk) {
    if (kk >= nkk) break;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned kf[4];
      const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int c = kk * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(kf, x + r * LDC + c);
      mma_bf16(sc[2 * np], af[kk], kf[0], kf[1]);
      mma_bf16(sc[2 * np + 1], af[kk], kf[2], kf[3]);
    }
  }
}

// acc (16 x 64) += bf16(P) (16 x 16: a chunk's C fragments) . X for X the
// 16 rows at x of a shared tile; output column groups of 16 from ndp on
// are past d and skipped.
__device__ __forceinline__ void pv_chunk(float (&acc)[8][4], float (*p)[4],
                                         const bf16* x, int ndp, int lane) {
  unsigned pa[4];
  pa[0] = pack_bf16x2(p[0][0], p[0][1]);
  pa[1] = pack_bf16x2(p[0][2], p[0][3]);
  pa[2] = pack_bf16x2(p[1][0], p[1][1]);
  pa[3] = pack_bf16x2(p[1][2], p[1][3]);
#pragma unroll
  for (int dp = 0; dp < CW / 16; ++dp) {
    if (dp >= ndp) break;
    unsigned f[4];
    const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int col = dp * 16 + (lane >> 4) * 8;
    ldmatrix_x4_trans(f, x + r * LDC + col);
    mma_bf16(acc[2 * dp], pa, f[0], f[1]);
    mma_bf16(acc[2 * dp + 1], pa, f[2], f[3]);
  }
}

__device__ __forceinline__ void zero(float (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[i][c] = 0.f;
}

// k16 steps of chunk c that hold columns below dh; 16-column groups of
// output chunk c below dh
__device__ __forceinline__ int chunk_steps(int dh, int c) {
  return min(CW / 16, (dh - c * CW + 15) / 16);
}

// Columns col, col + 1 (col even) of one head's output row (row: its
// column 0), those below dh: one 4-byte store where aligned, else two.
__device__ __forceinline__ void store_pair(bf16* row, int col, float a,
                                           float b, int dh) {
  if (col >= dh) return;
  bf16* p = row + col;
  if (col + 1 < dh && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<unsigned*>(p) = pack_bf16x2(a, b);
    return;
  }
  p[0] = __float2bfloat16_rn(a);
  if (col + 1 < dh) p[1] = __float2bfloat16_rn(b);
}

// The C fragment sc[nt][c] of 64 key columns: scaled, MASK_VALUE where the
// segments differ (sMk: the keys' ids), -inf for keys past S.
__device__ __forceinline__ void mask_tile(float (&sc)[8][4], const float* sMk,
                                          int k0, int S, float qma, float qmb,
                                          float sm_scale, int t4) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = nt * 8 + 2 * t4 + (c & 1);
      const float v = sc[nt][c] * sm_scale;
      sc[nt][c] = k0 + j >= S ? -INFINITY
                              : (sMk[j] == (c < 2 ? qma : qmb) ? v
                                                               : MASK_VALUE);
    }
  }
}

// One block's head: the operands at row 0, column 0 of its head, its
// Philox row 0 and the output rows' stride.
struct Head {
  const bf16 *q, *k, *v;
  const float* mrow;
  int prow0;
  size_t row0;
};

__device__ __forceinline__ Head head_of(const bf16* q, const bf16* k,
                                        const bf16* v, int ld,
                                        const float* mask, int S, int dh) {
  const int head = blockIdx.y, elem = blockIdx.z;
  Head h;
  h.row0 = (size_t)elem * S;
  const size_t off = h.row0 * ld + (size_t)head * dh;
  h.q = q + off;
  h.k = k + off;
  h.v = v + off;
  h.mrow = mask + h.row0;
  h.prow0 = (elem * gridDim.y + head) * S;
  return h;
}

// ---------------------------------------------------------------------- //
// 1. chunked_fwd: 64 query rows a block
// ---------------------------------------------------------------------- //

// TILED: o = (drop(exp(s - m)) rounded) V * (1 / l) and st0 = lse;
// else o = drop(p = exp(s - m) / l) rounded . V, and st0 / st1 (if not
// null) = each row's max m and sum l.
template <bool DROP, bool TILED>
__global__ void __launch_bounds__(THREADS)
    chunked_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, int ld,
                       const float* __restrict__ mask, bf16* __restrict__ out,
                       float* __restrict__ st0, float* __restrict__ st1,
                       int S, int dh, int lv, float sm_scale,
                       DropParams drop) {
  __shared__ __align__(16) bf16 sQ[CELEMS];
  __shared__ __align__(16) bf16 sK[CELEMS];
  __shared__ __align__(16) bf16 sV[CELEMS];
  __shared__ float sMk[ROWS];
  __shared__ unsigned sKeep[ROWS * KSTRIDE];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * ROWS;
  const Head hd = head_of(q, k, v, ld, mask, S, dh);
  const int H = gridDim.y * dh;
  const int ra = warp * 16 + g, qa = q0 + ra, qb = qa + 8;
  const float nan = __int_as_float(0x7fc00000);
  const float qma = qa < S ? hd.mrow[qa] : nan;
  const float qmb = qb < S ? hd.mrow[qb] : nan;
  const int n_kt = (S + ROWS - 1) / ROWS, n_ch = (dh + CW - 1) / CW;

  // the masked scores of the 64 keys from k0, over every chunk (and the
  // tile's keep bits, if wanted)
  auto scores = [&](float (&sc)[8][4], int k0, bool keep) {
    zero(sc);
    for (int c = 0; c < n_ch; ++c) {
      __syncthreads();
      load_chunk(sQ, hd.q, q0, S, ld, c * CW, dh, lv);
      load_chunk(sK, hd.k, k0, S, ld, c * CW, dh, lv);
      cp_async_commit();
      if (c == 0) {
        for (int j = threadIdx.x; j < ROWS; j += THREADS)
          sMk[j] = k0 + j < S ? hd.mrow[k0 + j] : 0.f;
        if (DROP && keep)
          build_keep(sKeep, ROWS, KWORDS, KSTRIDE, drop, hd.prow0 + q0, k0);
      }
      cp_async_wait<0>();
      __syncthreads();
      chunk_scores(sc, sQ + warp * 16 * LDC, sK, chunk_steps(dh, c), lane);
    }
    mask_tile(sc, sMk, k0, S, qma, qmb, sm_scale, t4);
  };

  // pass 1: each row's max and sum of exp (the sum rescaled as the max
  // grows)
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    float sc[8][4];
    scores(sc, kt * ROWS, false);
    float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      ta = fmaxf(ta, fmaxf(sc[nt][0], sc[nt][1]));
      tb = fmaxf(tb, fmaxf(sc[nt][2], sc[nt][3]));
    }
    ta = quad_max(ta);
    tb = quad_max(tb);
    // the first tile holds key 0, so na and nb are finite
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
  la = quad_sum(la);
  lb = quad_sum(lb);
  if (t4 == 0) {
    if (TILED) {
      if (qa < S) st0[hd.prow0 + qa] = ma + logf(fmaxf(la, 1e-30f));
      if (qb < S) st0[hd.prow0 + qb] = mb + logf(fmaxf(lb, 1e-30f));
    } else if (st0 != nullptr) {
      if (qa < S) {
        st0[hd.prow0 + qa] = ma;
        st1[hd.prow0 + qa] = la;
      }
      if (qb < S) {
        st0[hd.prow0 + qb] = mb;
        st1[hd.prow0 + qb] = lb;
      }
    }
  }

  // pass 2, one output chunk at a time: the same scores, their probs
  // dropped and rounded to bf16, times the chunk of V
  const float rla = __frcp_rn(la), rlb = __frcp_rn(lb);
  const float ila = 1.f / la, ilb = 1.f / lb;
  for (int co = 0; co < n_ch; ++co) {
    const int ndp = chunk_steps(dh, co);
    float acc[8][4];
    zero(acc);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * ROWS;
      float sc[8][4];
      scores(sc, k0, true);
      load_chunk(sV, hd.v, k0, S, ld, co * CW, dh, lv);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        float p[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int nt = 2 * ks + j;
            const bool lo = c < 2;
            const float e = expf(sc[nt][c] - (lo ? ma : mb));
            float pv = TILED ? e
                             : (lo ? div_row(e, la, rla) : div_row(e, lb, rlb));
            if (DROP)  // keys past S: p is 0 already
              pv = kept(sKeep, KSTRIDE, ra + (c >> 1) * 8,
                        nt * 8 + 2 * t4 + (c & 1))
                       ? __fmul_rn(pv, drop.inv_keep)
                       : 0.f;
            p[j][c] = pv;
          }
        }
        pv_chunk(acc, p, sV + ks * 16 * LDC, ndp, lane);
      }
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const int col = co * CW + dt * 8 + 2 * t4;
      if (qa < S)
        store_pair(out + (hd.row0 + qa) * H + blockIdx.y * dh, col,
                   TILED ? acc[dt][0] * ila : acc[dt][0],
                   TILED ? acc[dt][1] * ila : acc[dt][1], dh);
      if (qb < S)
        store_pair(out + (hd.row0 + qb) * H + blockIdx.y * dh, col,
                   TILED ? acc[dt][2] * ilb : acc[dt][2],
                   TILED ? acc[dt][3] * ilb : acc[dt][3], dh);
    }
  }
}

// ---------------------------------------------------------------------- //
// 2. chunked_bwd_dq: 64 query rows a block, keys innermost
// ---------------------------------------------------------------------- //

// p = exp(s - st0) / st1 (st1 null: / 1, st0 the lse); di = rowsum(dO *
// O) if o is given, else rowsum(dp * p) over a first sweep of the keys;
// dq = bf16(p * (dp - di) * sm_scale) k.  dout and o have rows of
// n_heads * dh; dq has row stride ld_g.
template <bool DROP>
__global__ void __launch_bounds__(THREADS)
    chunked_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, int ld,
                      const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ mask,
                      const float* __restrict__ st0,
                      const float* __restrict__ st1, float* __restrict__ di,
                      bf16* __restrict__ dq, int ld_g, int S, int dh, int lv,
                      float sm_scale, DropParams drop) {
  __shared__ __align__(16) bf16 sQ[CELEMS];
  __shared__ __align__(16) bf16 sO[CELEMS];  // dO
  __shared__ __align__(16) bf16 sK[CELEMS];
  __shared__ __align__(16) bf16 sV[CELEMS];
  __shared__ float sMk[ROWS];
  __shared__ float sDi[ROWS];
  __shared__ unsigned sKeep[ROWS * KSTRIDE];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * ROWS;
  const Head hd = head_of(q, k, v, ld, mask, S, dh);
  const int H = gridDim.y * dh;
  const size_t off_h = hd.row0 * H + (size_t)blockIdx.y * dh;
  const bf16* do_src = dout + off_h;
  const int ra = warp * 16 + g, qa = q0 + ra, qb = qa + 8;
  const float nan = __int_as_float(0x7fc00000);
  const float qma = qa < S ? hd.mrow[qa] : nan;
  const float qmb = qb < S ? hd.mrow[qb] : nan;
  // rows past S: m = 0 turns their MASK_VALUE scores into p = 0
  const float ma = qa < S ? st0[hd.prow0 + qa] : 0.f;
  const float mb = qb < S ? st0[hd.prow0 + qb] : 0.f;
  const float la = st1 != nullptr && qa < S ? st1[hd.prow0 + qa] : 1.f;
  const float lb = st1 != nullptr && qb < S ? st1[hd.prow0 + qb] : 1.f;
  const float rla = __frcp_rn(la), rlb = __frcp_rn(lb);
  const int n_kt = (S + ROWS - 1) / ROWS, n_ch = (dh + CW - 1) / CW;

  // the masked scores and raw dP of the 64 keys from k0 over every
  // chunk, and the tile's keep bits
  auto scores_dp = [&](float (&sc)[8][4], float (&dp)[8][4], int k0) {
    zero(sc);
    zero(dp);
    for (int c = 0; c < n_ch; ++c) {
      __syncthreads();
      load_chunk(sQ, hd.q, q0, S, ld, c * CW, dh, lv);
      load_chunk(sO, do_src, q0, S, H, c * CW, dh, lv);
      load_chunk(sK, hd.k, k0, S, ld, c * CW, dh, lv);
      load_chunk(sV, hd.v, k0, S, ld, c * CW, dh, lv);
      cp_async_commit();
      if (c == 0) {
        for (int j = threadIdx.x; j < ROWS; j += THREADS)
          sMk[j] = k0 + j < S ? hd.mrow[k0 + j] : 0.f;
        if (DROP)
          build_keep(sKeep, ROWS, KWORDS, KSTRIDE, drop, hd.prow0 + q0, k0);
      }
      cp_async_wait<0>();
      __syncthreads();
      const int nkk = chunk_steps(dh, c);
      chunk_scores(sc, sQ + warp * 16 * LDC, sK, nkk, lane);
      chunk_scores(dp, sO + warp * 16 * LDC, sV, nkk, lane);
    }
    mask_tile(sc, sMk, k0, S, qma, qmb, sm_scale, t4);
  };
  // sc -> p, dp -> the dropped dp
  auto probs = [&](float (&sc)[8][4], float (&dp)[8][4]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool lo = c < 2;
        const float e = expf(sc[nt][c] - (lo ? ma : mb));
        sc[nt][c] = lo ? div_row(e, la, rla) : div_row(e, lb, rlb);
        if (DROP)
          dp[nt][c] = kept(sKeep, KSTRIDE, ra + (c >> 1) * 8,
                           nt * 8 + 2 * t4 + (c & 1))
                          ? __fmul_rn(dp[nt][c], drop.inv_keep)
                          : 0.f;
      }
    }
  };

  if (o != nullptr) {
    // di = rowsum(f32(dO) * f32(O)): a warp a row at a time, its lanes
    // striding the columns (rows past S: 0)
    for (int r = warp; r < ROWS; r += THREADS / 32) {
      float sum = 0.f;
      if (q0 + r < S) {
        const size_t base = off_h + (size_t)(q0 + r) * H;
        for (int c = lane; c < dh; c += 32)
          sum = __fadd_rn(sum, __fmul_rn(__bfloat162float(dout[base + c]),
                                         __bfloat162float(o[base + c])));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        sDi[r] = sum;
        if (q0 + r < S) di[hd.prow0 + q0 + r] = sum;
      }
    }
  } else {
    // di = rowsum(dp * p) over every key tile
    float da = 0.f, db = 0.f;
    for (int kt = 0; kt < n_kt; ++kt) {
      float sc[8][4], dp[8][4];
      scores_dp(sc, dp, kt * ROWS);
      probs(sc, dp);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        da = __fadd_rn(da, __fmul_rn(dp[nt][0], sc[nt][0]));
        da = __fadd_rn(da, __fmul_rn(dp[nt][1], sc[nt][1]));
        db = __fadd_rn(db, __fmul_rn(dp[nt][2], sc[nt][2]));
        db = __fadd_rn(db, __fmul_rn(dp[nt][3], sc[nt][3]));
      }
    }
    da = quad_sum(da);
    db = quad_sum(db);
    if (t4 == 0) {
      sDi[ra] = da;
      sDi[ra + 8] = db;
      if (qa < S) di[hd.prow0 + qa] = da;
      if (qb < S) di[hd.prow0 + qb] = db;
    }
  }
  __syncthreads();
  const float dia = sDi[ra], dib = sDi[ra + 8];

  // one output chunk at a time: dq_c += bf16(p * (dp - di) * sm_scale) k_c
  for (int co = 0; co < n_ch; ++co) {
    const int ndp = chunk_steps(dh, co);
    float acc[8][4];
    zero(acc);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * ROWS;
      float sc[8][4], dp[8][4];
      scores_dp(sc, dp, k0);
      probs(sc, dp);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sc[nt][c] = __fmul_rn(
              __fmul_rn(sc[nt][c], __fsub_rn(dp[nt][c], c < 2 ? dia : dib)),
              sm_scale);
      __syncthreads();  // every warp's score products are done with sK
      load_chunk(sK, hd.k, k0, S, ld, co * CW, dh, lv);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        pv_chunk(acc, &sc[2 * ks], sK + ks * 16 * LDC, ndp, lane);
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const int col = co * CW + dt * 8 + 2 * t4;
      if (qa < S)
        store_pair(dq + (hd.row0 + qa) * ld_g + blockIdx.y * dh, col,
                   acc[dt][0], acc[dt][1], dh);
      if (qb < S)
        store_pair(dq + (hd.row0 + qb) * ld_g + blockIdx.y * dh, col,
                   acc[dt][2], acc[dt][3], dh);
    }
  }
}

// ---------------------------------------------------------------------- //
// 3. chunked_bwd_dkv: 64 key rows a block, queries innermost
// ---------------------------------------------------------------------- //

// S^T = K Q^T and dP^T = V dO^T with the keys as rows (the same k16
// steps as the forward's products), p and di per query as the dq kernel
// takes them; dv_c += bf16(drop(p))^T dO_c, dk_c += bf16(ds)^T Q_c.
template <bool DROP>
__global__ void __launch_bounds__(THREADS)
    chunked_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, int ld,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ mask,
                       const float* __restrict__ st0,
                       const float* __restrict__ st1,
                       const float* __restrict__ di, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int ld_g, int S, int dh, int lv,
                       float sm_scale, DropParams drop) {
  __shared__ __align__(16) bf16 sK[CELEMS];
  __shared__ __align__(16) bf16 sV[CELEMS];
  __shared__ __align__(16) bf16 sQ[CELEMS];
  __shared__ __align__(16) bf16 sO[CELEMS];  // dO
  __shared__ float sMq[ROWS];
  __shared__ float sSt[4 * ROWS];  // per query of the tile: m, l, di, 1 / l
  __shared__ unsigned sKeep[ROWS * KSTRIDE];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * ROWS;
  const Head hd = head_of(q, k, v, ld, mask, S, dh);
  const int H = gridDim.y * dh;
  const bf16* do_src = dout + hd.row0 * H + (size_t)blockIdx.y * dh;
  const int kla = warp * 16 + g;  // this thread's keys, relative to k0
  const int ka = k0 + kla, kb = ka + 8;
  const float kma = ka < S ? hd.mrow[ka] : 0.f;
  const float kmb = kb < S ? hd.mrow[kb] : 0.f;
  const int n_qt = (S + ROWS - 1) / ROWS, n_ch = (dh + CW - 1) / CW;

  for (int co = 0; co < n_ch; ++co) {
    const int ndp = chunk_steps(dh, co);
    float dka[8][4], dva[8][4];
    zero(dka);
    zero(dva);
    for (int qt = 0; qt < n_qt; ++qt) {
      const int qt0 = qt * ROWS;
      float st[8][4], dpt[8][4];  // S^T, dP^T: rows keys, columns queries
      zero(st);
      zero(dpt);
      for (int c = 0; c < n_ch; ++c) {
        __syncthreads();
        load_chunk(sK, hd.k, k0, S, ld, c * CW, dh, lv);
        load_chunk(sV, hd.v, k0, S, ld, c * CW, dh, lv);
        load_chunk(sQ, hd.q, qt0, S, ld, c * CW, dh, lv);
        load_chunk(sO, do_src, qt0, S, H, c * CW, dh, lv);
        cp_async_commit();
        if (c == 0) {
          for (int j = threadIdx.x; j < ROWS; j += THREADS) {
            const int qr = qt0 + j;
            const bool ok = qr < S;
            sMq[j] = ok ? hd.mrow[qr] : 0.f;
            sSt[j] = ok ? st0[hd.prow0 + qr] : 0.f;
            sSt[ROWS + j] = ok && st1 != nullptr ? st1[hd.prow0 + qr] : 1.f;
            sSt[2 * ROWS + j] = ok ? di[hd.prow0 + qr] : 0.f;
            sSt[3 * ROWS + j] = __frcp_rn(sSt[ROWS + j]);
          }
          // keep bits of the tile's queries (rows) against this block's
          // 64 keys
          if (DROP)
            build_keep(sKeep, ROWS, KWORDS, KSTRIDE, drop, hd.prow0 + qt0,
                       k0);
        }
        cp_async_wait<0>();
        __syncthreads();
        const int nkk = chunk_steps(dh, c);
        chunk_scores(st, sK + warp * 16 * LDC, sQ, nkk, lane);
        chunk_scores(dpt, sV + warp * 16 * LDC, sO, nkk, lane);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = nt * 8 + 2 * t4 + (e & 1);
          const int qr = qt0 + ql;
          const bool lo = e < 2;
          const int kr = lo ? ka : kb;
          const float sv = st[nt][e] * sm_scale;
          const float s = (qr >= S || kr >= S)
                              ? -INFINITY
                              : (sMq[ql] == (lo ? kma : kmb) ? sv : MASK_VALUE);
          const float p =
              div_row(expf(s - sSt[ql]), sSt[ROWS + ql], sSt[3 * ROWS + ql]);
          float pd = p, d = dpt[nt][e];
          if (DROP) {
            const bool keep =
                qr < S && kept(sKeep, KSTRIDE, ql, kr - k0);
            pd = keep ? __fmul_rn(p, drop.inv_keep) : 0.f;
            d = keep ? __fmul_rn(d, drop.inv_keep) : 0.f;
          }
          dpt[nt][e] = pd;
          st[nt][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(d, sSt[2 * ROWS + ql])),
                                sm_scale);
        }
      }
      __syncthreads();  // every warp's products are done with sQ and sO
      load_chunk(sQ, hd.q, qt0, S, ld, co * CW, dh, lv);
      load_chunk(sO, do_src, qt0, S, H, co * CW, dh, lv);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int qs = 0; qs < 4; ++qs) {
        pv_chunk(dva, &dpt[2 * qs], sO + qs * 16 * LDC, ndp, lane);
        pv_chunk(dka, &st[2 * qs], sQ + qs * 16 * LDC, ndp, lane);
      }
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const int col = co * CW + dt * 8 + 2 * t4;
      if (ka < S) {
        const size_t r = (hd.row0 + ka) * ld_g + blockIdx.y * dh;
        store_pair(dk + r, col, dka[dt][0], dka[dt][1], dh);
        store_pair(dv + r, col, dva[dt][0], dva[dt][1], dh);
      }
      if (kb < S) {
        const size_t r = (hd.row0 + kb) * ld_g + blockIdx.y * dh;
        store_pair(dk + r, col, dka[dt][2], dka[dt][3], dh);
        store_pair(dv + r, col, dva[dt][2], dva[dt][3], dh);
      }
    }
  }
}

// The widest copy (log2 of its elements: 3 = 16 bytes .. 0 = 2 bytes) that
// d, the row strides and every operand's address allow.
int copy_log2(std::initializer_list<const void*> ptrs,
              std::initializer_list<int> strides, int d) {
  for (int lv = 3; lv > 0; --lv) {
    const int n = 1 << lv;
    bool ok = d % n == 0;
    for (int s : strides) ok = ok && s % n == 0;
    for (const void* p : ptrs)
      ok = ok && (p == nullptr || reinterpret_cast<uintptr_t>(p) % (2 * n) == 0);
    if (ok) return lv;
  }
  return 0;
}

bool shape_ok(int B, int S, int n_heads, int d) {
  return B > 0 && S > 0 && n_heads > 0 && d > 0 &&
         (long long)B * n_heads * S < (1LL << 31) && n_heads < 65536 &&
         B < 65536;
}

int launched(int which) {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++chunked_launches[which];
  return (int)e;
}

}  // namespace

extern "C" {

// q, k, v: (B*S, ld) bf16, each operand's (n_heads * d) columns starting at
// its pointer (any alignment of a bf16 array); mask (B, S) f32 segment
// ids -> out (B*S, n_heads * d) bf16, any d >= 1, any S >= 1.  tiled: o =
// the tiled forward's (flash_fwd) and st0 (B, n_heads, S) f32 = lse;
// else the single-block forward's (seg_attention), st0 / st1 (if not
// null) = each row's max and sum of exp.  Prob dropout when drop_on.
int nbk_chunked_fwd(const void* q, const void* k, const void* v, int ld,
                    const float* mask, void* out, float* st0, float* st1,
                    int tiled, int B, int S, int n_heads, int d,
                    float sm_scale, unsigned long long seed, int stream,
                    unsigned thresh, float inv_keep, int drop_on,
                    void* cuda_stream) {
  if (!shape_ok(B, S, n_heads, d) || (tiled && st0 == nullptr) ||
      ((st0 == nullptr) != (st1 == nullptr) && !tiled))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const DropParams drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  const int lv = copy_log2({q, k, v}, {ld}, d);
  const dim3 grid((S + ROWS - 1) / ROWS, n_heads, B);
  const bf16 *bq = static_cast<const bf16*>(q),
             *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v);
  bf16* bo = static_cast<bf16*>(out);
#define NBK_CHUNKED_FWD(DROP, TILED)                                     \
  chunked_fwd_kernel<DROP, TILED><<<grid, THREADS, 0, s>>>(              \
      bq, bk, bv, ld, mask, bo, st0, st1, S, d, lv, sm_scale, drop)
  if (drop.on) {
    if (tiled)
      NBK_CHUNKED_FWD(true, true);
    else
      NBK_CHUNKED_FWD(true, false);
  } else {
    if (tiled)
      NBK_CHUNKED_FWD(false, true);
    else
      NBK_CHUNKED_FWD(false, false);
  }
#undef NBK_CHUNKED_FWD
  return launched(0);
}

// q, k, v as nbk_chunked_fwd reads them, dout (B*S, n_heads * d) bf16,
// st0 / st1 the single-block forward's max and sum (st1 null: st0 is the
// tiled forward's lse) -> dq with row stride ld_g and di (B, n_heads, S)
// f32: rowsum(dO * O) if o (the tiled forward's output) is given, else
// rowsum(dp * p).
int nbk_chunked_bwd_dq(const void* q, const void* k, const void* v, int ld,
                       const void* o, const void* dout, const float* mask,
                       const float* st0, const float* st1, float* di,
                       void* dq, int ld_g, int B, int S, int n_heads, int d,
                       float sm_scale, unsigned long long seed, int stream,
                       unsigned thresh, float inv_keep, int drop_on,
                       void* cuda_stream) {
  if (!shape_ok(B, S, n_heads, d) || st0 == nullptr || di == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const DropParams drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  const int lv = copy_log2({q, k, v, dout}, {ld, n_heads * d}, d);
  const dim3 grid((S + ROWS - 1) / ROWS, n_heads, B);
  const bf16 *bq = static_cast<const bf16*>(q),
             *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v),
             *bo = static_cast<const bf16*>(o),
             *bd = static_cast<const bf16*>(dout);
  bf16* bdq = static_cast<bf16*>(dq);
  if (drop.on)
    chunked_dq_kernel<true><<<grid, THREADS, 0, s>>>(
        bq, bk, bv, ld, bo, bd, mask, st0, st1, di, bdq, ld_g, S, d, lv,
        sm_scale, drop);
  else
    chunked_dq_kernel<false><<<grid, THREADS, 0, s>>>(
        bq, bk, bv, ld, bo, bd, mask, st0, st1, di, bdq, ld_g, S, d, lv,
        sm_scale, drop);
  return launched(1);
}

// The same operands, di from nbk_chunked_bwd_dq -> dk and dv with row
// stride ld_g.
int nbk_chunked_bwd_dkv(const void* q, const void* k, const void* v, int ld,
                        const void* dout, const float* mask,
                        const float* st0, const float* st1, const float* di,
                        void* dk, void* dv, int ld_g, int B, int S,
                        int n_heads, int d, float sm_scale,
                        unsigned long long seed, int stream, unsigned thresh,
                        float inv_keep, int drop_on, void* cuda_stream) {
  if (!shape_ok(B, S, n_heads, d) || st0 == nullptr || di == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const DropParams drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  const int lv = copy_log2({q, k, v, dout}, {ld, n_heads * d}, d);
  const dim3 grid((S + ROWS - 1) / ROWS, n_heads, B);
  const bf16 *bq = static_cast<const bf16*>(q),
             *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v),
             *bd = static_cast<const bf16*>(dout);
  bf16 *bdk = static_cast<bf16*>(dk), *bdv = static_cast<bf16*>(dv);
  if (drop.on)
    chunked_dkv_kernel<true><<<grid, THREADS, 0, s>>>(
        bq, bk, bv, ld, bd, mask, st0, st1, di, bdk, bdv, ld_g, S, d, lv,
        sm_scale, drop);
  else
    chunked_dkv_kernel<false><<<grid, THREADS, 0, s>>>(
        bq, bk, bv, ld, bd, mask, st0, st1, di, bdk, bdv, ld_g, S, d, lv,
        sm_scale, drop);
  return launched(2);
}

// Launches of the chunked kernels since the library was loaded: 0
// chunked_fwd, 1 chunked_bwd_dq, 2 chunked_bwd_dkv; -1 for any other.
long long nbk_chunked_launches(int kernel) {
  return kernel >= 0 && kernel < 3 ? chunked_launches[kernel] : -1;
}

}  // extern "C"
