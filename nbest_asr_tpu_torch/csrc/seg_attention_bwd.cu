// The attention backward: dq, dk, dv from q, k, v (read by row stride and
// column offset, as the forward reads them), the ctx gradient dO (n, h)
// bf16, the segment mask and the forward's row statistics
// (seg_attention.cu: max m and sum l of each score row); dq, dk, dv are
// written with their own row stride -- into the q | k | v column blocks of
// one (n, 3h) gradient buffer, or into (b, s, heads, d) tensors.
//
// Replaces the head loop of the TPU attention-block backward
//   nbest_asr_tpu/ops/fused_attention.py:_fab_bwd_kernel (:235-266),
// and the single-block flash backward
//   nbest_asr_tpu/ops/flash_attention.py:_sb_bwd_kernel (:380),
// which compute the same function; per (element, head) they recompute
// the probs and compute
//   dp   = dO v^T, dropped with the forward's mask and scale
//   p_v  = drop(p)                      dv = bf16(p_v)^T dO
//   di   = rowsum(dp * p)  (undropped p, f32)
//   ds   = bf16(p * (dp - di) * sm_scale)
//   dq   = ds k,  dk = ds^T q
// Here p = exp(s - m) / l from the saved statistics.  At head dims other
// than 64 the dQ kernel's p is the forward's bit for bit (same score MMAs,
// same order).  At d = 64 the forward takes its scores from wgmma and these
// kernels from mma.sync, which may round a score differently in its last
// f32 bit; on the H100 the rebuilt probs, rounded to bf16 as both kernels
// round them for P.V, equalled the forward's in all 196,608 of the smoke's
// probe and all 16,384 of the card test (PERF.md, Findings).  The prob
// mask does not depend on the scores: it is Philox stream 3, regenerated
// from its counters (attention.cuh), bit for bit at every head dim.
// di is the TPU kernel's own rowsum(dp * p) in f32 -- not FlashAttention's
// rowsum(dO * O), which equals it only up to the bf16 rounding of P and O.
//
// Design: dK and dV sum over queries, dQ over keys, and blocks run in no
// order, so the sums are split as in the JAX tiled flash backward, with
// no atomics and a result that does not depend on scheduling:
//   1. dq kernel, per (element, head, 64-query tile), keys innermost
//      (flash_attention.py:276 _bwd_dq_kernel): sweep 1 over the key
//      tiles sums di for its rows (and stores it), sweep 2 recomputes p
//      and dp and accumulates dq;
//   2. dkv kernel, per (element, head, 64-key tile), queries innermost
//      (flash_attention.py:226 _bwd_dkv_kernel): keys are the warps' rows,
//      so S^T = K Q^T and dP^T = V dO^T come out as C fragments that are
//      directly the A fragments of dV += P_v^T dO and dK += dS^T Q; it
//      reads di from kernel 1.
// Each warp owns 16 rows and works in 16-column chunks, so registers hold
// only the row block's fragments and accumulators; the keep bits of the
// block's (rows x S) slab are drawn once into shared memory.
//
// What bounds it on the H100: per head 7-9 s*s*d MMAs (dq recomputes the
// scores and dp twice) on a few 64-row tiles, so the serial tile loops
// and shared-memory traffic of these small tiles bound it, not HBM (about
// 7 n h bytes) or tensor-core rate; the keep bits cost one Philox call
// per four probs per kernel.
#include "attention.cuh"

namespace {

using namespace nbk;
using namespace nbk::attn;

template <int D>
size_t dq_smem(int S) {
  return (size_t)4 * Tile<D>::ELEMS * sizeof(bf16) +
         (size_t)S * sizeof(float) +
         (size_t)ROWS * keep_stride(S) * sizeof(unsigned);
}

template <int D>
size_t dkv_smem(int S) {
  return (size_t)4 * Tile<D>::ELEMS * sizeof(bf16) +
         (size_t)(S + 3 * ROWS) * sizeof(float) +
         (size_t)S * 2 * sizeof(unsigned);
}

// -------------------------------------------------------------------- //
// 1. dq (and di), per 64-query tile, keys innermost
// -------------------------------------------------------------------- //

// The chunk's probs p (undropped) and dropped dp, from raw scores sc and
// raw dp, keys key0 + (chunk columns), this thread's rows ra / ra + 8 of
// the keep table.
__device__ __forceinline__ void chunk_probs(float (*sc)[4], float (*dp)[4],
                                            const float* sM,
                                            const unsigned* tab, int kstride,
                                            int ra, int key0, int S,
                                            float qma, float qmb, float ma,
                                            float mb, float la, float lb,
                                            float sm_scale,
                                            const DropParams& drop, int t4) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = key0 + j * 8 + 2 * t4 + (e & 1);
      const bool lo = e < 2;
      const float v = sc[j][e] * sm_scale;
      const float s =
          k >= S ? -INFINITY : (sM[k] == (lo ? qma : qmb) ? v : MASK_VALUE);
      sc[j][e] = lo ? expf(s - ma) / la : expf(s - mb) / lb;
      if (drop.on)  // the table holds keys < S; p is 0 past S anyway
        dp[j][e] = k < S && kept(tab, kstride, ra + (e >> 1) * 8, k)
                       ? __fmul_rn(dp[j][e], drop.inv_keep)
                       : 0.f;
    }
  }
}

// Both kernels are built for 4 blocks per SM at d = 32 and 64 (128
// registers; at d = 64 unbounded they take 161 and 169, and the bounded
// pair, spills and all, ran 18% faster at 32 x 256 on the H100); the d =
// 192 and 256 instances spill their fragments and accumulators to local
// memory.  q, k, v (row stride ld) and dq, dk, dv (row stride ld_g): row
// 0, column 0 of each operand's head block; dctx has rows of n_heads * D.
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : 1)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, int ld,
              const bf16* __restrict__ dctx, const float* __restrict__ mask,
              const float* __restrict__ stats, float* __restrict__ di,
              bf16* __restrict__ dq, int ld_g, int S, float sm_scale,
              DropParams drop) {
  constexpr int LD = Tile<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + Tile<D>::ELEMS;  // dO
  bf16* sK = sO + Tile<D>::ELEMS;
  bf16* sV = sK + Tile<D>::ELEMS;
  float* sM = reinterpret_cast<float*>(sV + Tile<D>::ELEMS);
  unsigned* sKeep = reinterpret_cast<unsigned*>(sM + S);
  const int kstride = keep_stride(S);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * ROWS, head = blockIdx.y, elem = blockIdx.z;
  const int n_heads = gridDim.y;
  const int H = n_heads * D;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;
  const size_t bhs = (size_t)gridDim.z * n_heads * S;
  const size_t off = row0 * ld + head * D;
  const bf16* q_src = q + off;
  const bf16* k_src = k + off;
  const bf16* v_src = v + off;

  for (int j = threadIdx.x; j < S; j += THREADS) sM[j] = mask[row0 + j];
  load_tile<D>(sQ, q_src, q0, S, ld);
  load_tile<D>(sO, dctx + row0 * H + head * D, q0, S, H);
  cp_async_commit();
  if (drop.on)
    build_keep(sKeep, ROWS, (S + 31) / 32, kstride, drop, prow0 + q0, 0);
  cp_async_wait<0>();
  __syncthreads();

  unsigned qf[D / 16][4], of[D / 16][4];
  load_a<D>(qf, sQ + warp * 16 * LD, lane);
  load_a<D>(of, sO + warp * 16 * LD, lane);

  const int g = lane >> 2, t4 = lane & 3;
  const int ra = warp * 16 + g;
  const int qa = q0 + ra, qb = qa + 8;
  const float nan = __int_as_float(0x7fc00000);
  const float qma = qa < S ? sM[qa] : nan, qmb = qb < S ? sM[qb] : nan;
  // rows past S: m = 0 turns their MASK_VALUE scores into p = 0
  const float ma = qa < S ? stats[prow0 + qa] : 0.f;
  const float mb = qb < S ? stats[prow0 + qb] : 0.f;
  const float la = qa < S ? stats[bhs + prow0 + qa] : 1.f;
  const float lb = qb < S ? stats[bhs + prow0 + qb] : 1.f;
  const int n_kt = (S + ROWS - 1) / ROWS;

  // sweep 1: di = rowsum(dp * p)
  float da = 0.f, db = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<D>(sK, k_src, kt * ROWS, S, ld);
    load_tile<D>(sV, v_src, kt * ROWS, S, ld);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float sc[2][4], dp[2][4];
      dot_nt16<D>(sc, qf, sK + ks * 16 * LD, lane);
      dot_nt16<D>(dp, of, sV + ks * 16 * LD, lane);
      chunk_probs(sc, dp, sM, sKeep, kstride, ra, kt * ROWS + ks * 16, S,
                  qma, qmb, ma, mb, la, lb, sm_scale, drop, t4);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        da = __fadd_rn(da, __fmul_rn(dp[j][0], sc[j][0]));
        da = __fadd_rn(da, __fmul_rn(dp[j][1], sc[j][1]));
        db = __fadd_rn(db, __fmul_rn(dp[j][2], sc[j][2]));
        db = __fadd_rn(db, __fmul_rn(dp[j][3], sc[j][3]));
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    da += __shfl_xor_sync(0xffffffffu, da, o);
    db += __shfl_xor_sync(0xffffffffu, db, o);
  }
  if (t4 == 0) {
    if (qa < S) di[prow0 + qa] = da;
    if (qb < S) di[prow0 + qb] = db;
  }

  // sweep 2: dq += bf16(p * (dp - di) * sm_scale) k
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<D>(sK, k_src, kt * ROWS, S, ld);
    load_tile<D>(sV, v_src, kt * ROWS, S, ld);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float sc[2][4], dp[2][4];
      dot_nt16<D>(sc, qf, sK + ks * 16 * LD, lane);
      dot_nt16<D>(dp, of, sV + ks * 16 * LD, lane);
      chunk_probs(sc, dp, sM, sKeep, kstride, ra, kt * ROWS + ks * 16, S,
                  qma, qmb, ma, mb, la, lb, sm_scale, drop, t4);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = __fmul_rn(
              __fmul_rn(sc[j][e], __fsub_rn(dp[j][e], e < 2 ? da : db)),
              sm_scale);
      mma_chunk<D>(acc, sc, sK + ks * 16 * LD, lane);
    }
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = head * D + dt * 8 + 2 * t4;
    if (qa < S)
      *reinterpret_cast<unsigned*>(dq + (row0 + qa) * ld_g + col) =
          pack_bf16x2(acc[dt][0], acc[dt][1]);
    if (qb < S)
      *reinterpret_cast<unsigned*>(dq + (row0 + qb) * ld_g + col) =
          pack_bf16x2(acc[dt][2], acc[dt][3]);
  }
}

// -------------------------------------------------------------------- //
// 2. dk, dv, per 64-key tile, queries innermost
// -------------------------------------------------------------------- //

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : 1)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, int ld,
               const bf16* __restrict__ dctx, const float* __restrict__ mask,
               const float* __restrict__ stats, const float* __restrict__ di,
               bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
               int ld_g, int S, float sm_scale, DropParams drop) {
  constexpr int LD = Tile<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + Tile<D>::ELEMS;
  bf16* sQ = sV + Tile<D>::ELEMS;
  bf16* sO = sQ + Tile<D>::ELEMS;  // dO
  float* sM = reinterpret_cast<float*>(sO + Tile<D>::ELEMS);
  float* sSt = sM + S;  // per query of the tile: m, l, di
  unsigned* sKeep = reinterpret_cast<unsigned*>(sSt + 3 * ROWS);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * ROWS, head = blockIdx.y, elem = blockIdx.z;
  const int n_heads = gridDim.y;
  const int H = n_heads * D;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;
  const size_t bhs = (size_t)gridDim.z * n_heads * S;
  const size_t off = row0 * ld + head * D;
  const bf16* q_src = q + off;
  const bf16* k_src = k + off;
  const bf16* v_src = v + off;
  const bf16* o_src = dctx + row0 * H + head * D;

  for (int j = threadIdx.x; j < S; j += THREADS) sM[j] = mask[row0 + j];
  load_tile<D>(sK, k_src, k0, S, ld);
  load_tile<D>(sV, v_src, k0, S, ld);
  cp_async_commit();
  // keep bits of every query row against this block's 64 keys: table row
  // q, word w = keys k0 + 32 w ..
  if (drop.on) build_keep(sKeep, S, 2, 2, drop, prow0, k0);
  cp_async_wait<0>();
  __syncthreads();

  unsigned kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, sK + warp * 16 * LD, lane);
  load_a<D>(vf, sV + warp * 16 * LD, lane);

  const int g = lane >> 2, t4 = lane & 3;
  const int kla = warp * 16 + g;  // this thread's keys, relative to k0
  const int ka = k0 + kla, kb = ka + 8;
  const float kma = ka < S ? sM[ka] : 0.f, kmb = kb < S ? sM[kb] : 0.f;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[dt][c] = dv[dt][c] = 0.f;

  const int n_qt = (S + ROWS - 1) / ROWS;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int qt0 = qt * ROWS;
    __syncthreads();
    load_tile<D>(sQ, q_src, qt0, S, ld);
    load_tile<D>(sO, o_src, qt0, S, H);
    cp_async_commit();
    for (int j = threadIdx.x; j < ROWS; j += THREADS) {
      const int qr = qt0 + j;
      const bool ok = qr < S;
      sSt[j] = ok ? stats[prow0 + qr] : 0.f;
      sSt[ROWS + j] = ok ? stats[bhs + prow0 + qr] : 1.f;
      sSt[2 * ROWS + j] = ok ? di[prow0 + qr] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int qs = 0; qs < 4; ++qs) {
      float st[2][4], dpt[2][4];  // S^T and dP^T: rows keys, cols queries
      dot_nt16<D>(st, kf, sQ + qs * 16 * LD, lane);
      dot_nt16<D>(dpt, vf, sO + qs * 16 * LD, lane);
      float pv[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = qs * 16 + j * 8 + 2 * t4 + (e & 1);
          const int qr = qt0 + ql;
          const bool lo = e < 2;
          const int kr = lo ? ka : kb;
          const float sv = st[j][e] * sm_scale;
          const float s = (qr >= S || kr >= S)
                              ? -INFINITY
                              : (sM[qr] == (lo ? kma : kmb) ? sv : MASK_VALUE);
          const float p = expf(s - sSt[ql]) / sSt[ROWS + ql];
          float pd = p, d = dpt[j][e];
          if (drop.on && !(qr < S && kept(sKeep, 2, qr, kr - k0))) {
            pd = 0.f;
            d = 0.f;
          } else if (drop.on) {
            pd = __fmul_rn(p, drop.inv_keep);
            d = __fmul_rn(d, drop.inv_keep);
          }
          pv[j][e] = pd;
          st[j][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(d, sSt[2 * ROWS + ql])),
                               sm_scale);
        }
      }
      mma_chunk<D>(dv, pv, sO + qs * 16 * LD, lane);
      mma_chunk<D>(dk, st, sQ + qs * 16 * LD, lane);
    }
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = head * D + dt * 8 + 2 * t4;
    if (ka < S) {
      const size_t r = (row0 + ka) * ld_g + col;
      *reinterpret_cast<unsigned*>(dk_out + r) =
          pack_bf16x2(dk[dt][0], dk[dt][1]);
      *reinterpret_cast<unsigned*>(dv_out + r) =
          pack_bf16x2(dv[dt][0], dv[dt][1]);
    }
    if (kb < S) {
      const size_t r = (row0 + kb) * ld_g + col;
      *reinterpret_cast<unsigned*>(dk_out + r) =
          pack_bf16x2(dk[dt][2], dk[dt][3]);
      *reinterpret_cast<unsigned*>(dv_out + r) =
          pack_bf16x2(dv[dt][2], dv[dt][3]);
    }
  }
}

struct Operands {  // host side only: the kernels take them as arguments
  const bf16 *q, *k, *v, *dctx;
  const float *mask, *stats;
  float* di;
  bf16 *dq, *dk, *dv;
  int ld, ld_g, B, S, n_heads;
  float sm_scale;
  DropParams drop;
};

template <int D>
int launch(const Operands& a, cudaStream_t stream) {
  const size_t s1 = dq_smem<D>(a.S), s2 = dkv_smem<D>(a.S);
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkv_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)s2);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.S + ROWS - 1) / ROWS, a.n_heads, a.B);
  dq_kernel<D><<<grid, THREADS, s1, stream>>>(
      a.q, a.k, a.v, a.ld, a.dctx, a.mask, a.stats, a.di, a.dq, a.ld_g, a.S,
      a.sm_scale, a.drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkv_kernel<D><<<grid, THREADS, s2, stream>>>(
      a.q, a.k, a.v, a.ld, a.dctx, a.mask, a.stats, a.di, a.dk, a.dv, a.ld_g,
      a.S, a.sm_scale, a.drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v as nbk_seg_attention reads them (row stride ld), dctx (B*S,
// n_heads * d) bf16, mask (B, S) f32, stats (2, B, n_heads, S) f32 from
// nbk_seg_attention -> dq, dk, dv bf16 with row stride ld_g (16-byte
// aligned, ld_g even: the q | k | v column blocks of one (B*S, 3h)
// buffer, or (B, S, n_heads, d) tensors); di (B, n_heads, S) f32 is
// scratch (rowsum(dp * p)).  d in {32, 64, 128, 192, 256}, S <= 512; the
// prob dropout as in the forward.
int nbk_seg_attention_bwd(const void* q, const void* k, const void* v,
                          int ld, const void* dctx, const float* mask,
                          const float* stats, float* di, void* dq, void* dk,
                          void* dv, int ld_g, int B, int S, int n_heads,
                          int d, float sm_scale, unsigned long long seed,
                          int stream, unsigned thresh, float inv_keep,
                          int drop_on, void* cuda_stream) {
  Operands a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dctx = static_cast<const bf16*>(dctx);
  a.mask = mask;
  a.stats = stats;
  a.di = di;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.ld = ld;
  a.ld_g = ld_g;
  a.B = B;
  a.S = S;
  a.n_heads = n_heads;
  a.sm_scale = sm_scale;
  a.drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  if (d == 32) return launch<32>(a, s);
  if (d == 64) return launch<64>(a, s);
  if (d == 128) return launch<128>(a, s);
  if (d == 192) return launch<192>(a, s);
  if (d == 256) return launch<256>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
