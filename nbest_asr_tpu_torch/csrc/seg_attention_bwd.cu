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
// Here p = exp(s - m) / l from the saved statistics, divided by div_row
// (attention.cuh) as the forward divides.  di is the TPU kernel's own
// rowsum(dp * p) in f32 -- not FlashAttention's rowsum(dO * O), which
// equals it only up to the bf16 rounding of P and O.  The prob mask is
// Philox stream 3, regenerated from its counters (attention.cuh), bit for
// bit at every head dim.
//
// dK and dV sum over queries, dQ over keys, and blocks run in no order,
// so each pair splits the sums as the JAX tiled flash backward does, with
// no atomics and a result that does not depend on scheduling: a dq kernel
// per (element, head, 64-query tile), keys innermost
// (flash_attention.py:276 _bwd_dq_kernel), which also writes di; then a
// dkv kernel per (element, head, 64-key tile), queries innermost
// (flash_attention.py:226 _bwd_dkv_kernel), which reads it.
//
// Three pairs; the caller names the instance (ops/kernels.py,
// attn_instance: the one rule) and nbk_seg_attention_bwd runs it or
// refuses:
//   d = 64, S <= 512        the wgmma pair (every DSTC2 bucket: 64, 96,
//   d = 96, S <= 256        160, 256; at d = 64 BERT's 512 positions,
//                           long length buckets and packed rows too)
//   d = 192, S <= 256       the d = 192 wgmma pair (section 4; the CLI's
//                           from-scratch heads, every DSTC2 bucket)
//   d = 192,                the streaming dq kernel and section 4's dkv
//   256 < S <= 512          kernel (section 5; that default on packed
//                           512-token rows, long buckets and N-best rows)
//   d = 96, 256 < S <= 512  the mma.sync pair (K and V would take 192 KB)
//   every other d <= 256    the mma.sync pair, on its instance of width
//   with d % 8 == 0         32, 64, 96, 128, 192 or 256 (attention.cuh,
//                           instance_width: a d between two widths runs
//                           on the wider, its columns past d zero-filled
//                           on load and never stored; d = 40 .. 56 on the
//                           64-wide pair, 72 .. 88 on the 96-wide one,
//                           136 .. 184 on the 192-wide one)
//
// The wgmma pair (section 3).  The dq kernel holds the head's K and V (the
// forward's NK-key window, NK = S rounded up to 32) and its tile's Q and
// dO in swizzled shared memory (at d = 96 a 128-byte panel of columns
// 0-63 and a 64-byte panel of columns 64-95, as the forward's:
// attention.cuh), issues S = Q K^T on the forward's own wgmma sequence
// (issue_scores: m64n64k16 chunks, an m64n32k16 tail), so the rebuilt
// scores and probs are the forward's bit for bit, and keeps the row's NK
// / 2 probs a thread in registers; then per 64-key chunk dP = dO V^T for
// di, and again for ds, whose bf16 values are packed in registers as the
// A fragments of dq += ds K (per chunk at d = 64; at d = 96 all chunks'
// ds first, then one product).  At d = 64 and S <= 256 a block is one
// warpgroup and one query tile; at d = 96, where K and V take 96 KB at S
// = 256, and at d = 64 past 256 keys (K and V 128 KB at S = 512), a block
// is one (element, head) and a run of its query tiles (double-buffered Q
// and dO), with two warpgroups that share K and V and split each tile's
// keys, adding their halves of di and dq through shared memory: a thread
// then holds half a window's probs (and at d = 96 its dP), where a whole
// window's probs alone (one warpgroup a tile) spilled at 256 keys at d =
// 96 and could not be held at 512 at d = 64.  Past 256 keys the forward
// splits a row into two 256-key windows, but each window's scores are
// m64n64k16 chunks from a multiple of 64, so any split into whole 64-key
// chunks rebuilds them bit for bit: the d = 64 dq kernel's warpgroups take
// halves of S rounded up to 128 (dq64x2_wgmma_kernel).  The
// dkv kernel holds its 64 keys' K and V and copies the head's Q and dO a
// tile at a time into two buffers (so three blocks fit an SM at d = 64
// and S <= 256; two at 96, and past 256 keys, where each query's
// statistics and keep bits take 14 KB at S = 512); per query tile it
// issues S and dP the same way with the
// queries as rows (the forward's orientation), rebuilds p, and stores
// drop(p) and ds as bf16 tiles in shared memory, which dV += drop(p)^T dO
// and dK += ds^T Q read transposed (MN-major; at d = 96 m64n64k16 on
// panel 0 and m64n32k16 on panel 1, 2 x 48 f32 accumulators a thread).
// The keep bits are drawn into shared memory while the first product
// runs.  Per head 8 s*s*d products at d = 64 against the function's own 5
// (S, dP, dV, dK, dQ): S and dP once more in the dkv kernel, dP once more
// in the dq kernel because di must be complete before ds; 7 at d = 96,
// whose dq kernel keeps dP in registers for ds.  What bounds it on the
// H100: not HBM (about 7 n h bytes) nor the tensor cores' rate but the
// elementwise instructions per (query, key) -- mask, expf, div_row, keep
// bit, the two drops, di and ds, some 40 a pair in each kernel -- issued
// by one or two warpgroups a block, one to three blocks an SM.
//
// The d = 192 pair (section 4): three 128-byte-swizzled panels a row
// (384 bytes), two warpgroups a block in both kernels, one block an SM.
// The dq kernel keeps the head's K (96 KB at S = 256) but not V -- K, V,
// Q and dO would take 240 KB -- so each warpgroup streams its half of the
// keys' V through a 64-key slot, and keeps its half's probs and dP in
// registers as the d = 96 kernel does (S, dP and dq here; S, dP, dV and
// dK in the dkv kernel: 7 s*s*d products a head).  The dkv
// kernel splits the work by accumulator, not by rows: one warpgroup
// issues S, rebuilds p and accumulates dV, the other issues dP, forms ds
// and accumulates dK (96 f32 registers each, where one warpgroup holding
// both spills), p passing between them through shared memory.  One block
// of eight warps an SM leaves the elementwise instructions' latency, and
// each tile's copies issued on the warpgroups' own paths, to bound both
// kernels: the dkv kernel's dS warpgroup issues the next tile's copies
// while the other rebuilds p (16-23% off the dkv kernel on the H100).
//
// Past 256 keys at d = 192 (section 5) K alone would take 192 KB, so the
// dq kernel keeps only its tile's Q and dO: its two warpgroups take
// alternate 64-key chunks and stream each chunk's K and V twice (S and dP
// for di, then S, dP and dq += ds K: 5 s*s*d products a head, beside the
// dkv kernel's 4), each holding a whole 64 x 192 partial dq; the dkv
// kernel, which streams Q and dO and holds only its 64 keys, runs
// unchanged at NK = 512.
//
// The mma.sync pair (sections 1 and 2): each warp owns 16 rows and works
// in 16-column chunks, so registers hold only the row block's fragments
// and accumulators; the dq kernel sweeps the key tiles twice (di, then
// dq), recomputing S and dP, and the dkv kernel holds keys as rows, so S^T
// = K Q^T and dP^T = V dO^T come out as C fragments that are directly the
// A fragments of dV += P_v^T dO and dK += dS^T Q.  Per head 7-9 s*s*d
// MMAs on 64-row tiles: the serial tile loops and shared-memory traffic
// bound it.
#include "attention.cuh"
#include "wgmma.cuh"

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
         (size_t)(S + 4 * ROWS) * sizeof(float) +
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
                                            float rla, float rlb,
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
      sc[j][e] = lo ? div_row(expf(s - ma), la, rla)
                    : div_row(expf(s - mb), lb, rlb);
      if (drop.on)  // the table holds keys < S; p is 0 past S anyway
        dp[j][e] = k < S && kept(tab, kstride, ra + (e >> 1) * 8, k)
                       ? __fmul_rn(dp[j][e], drop.inv_keep)
                       : 0.f;
    }
  }
}

// Both kernels are built for 4 blocks per SM at d = 32 and 64 (128
// registers; at d = 64 unbounded they take 161 and 169, and the bounded
// pair, spills and all, ran 18% faster at 32 x 256 on the H100), for 2 at
// d = 96 (the dK/dV kernel's K and V fragments and dK and dV accumulators
// take 144 registers); the d = 192 and 256 instances spill their
// fragments and accumulators to local memory.  q, k, v (row stride ld) and
// dq, dk, dv (row stride ld_g): row 0, column 0 of each operand's head
// block, dh <= D columns wide (columns past dh are zeros in the tiles);
// dctx has rows of n_heads * dh.
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : D == 96 ? 2 : 1)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, int ld,
              const bf16* __restrict__ dctx, const float* __restrict__ mask,
              const float* __restrict__ stats, float* __restrict__ di,
              bf16* __restrict__ dq, int ld_g, int S, int dh,
              float sm_scale, DropParams drop) {
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
  const int H = n_heads * dh;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;
  const size_t bhs = (size_t)gridDim.z * n_heads * S;
  const size_t off = row0 * ld + head * dh;
  const bf16* q_src = q + off;
  const bf16* k_src = k + off;
  const bf16* v_src = v + off;

  for (int j = threadIdx.x; j < S; j += THREADS) sM[j] = mask[row0 + j];
  load_tile<D>(sQ, q_src, q0, S, ld, dh);
  load_tile<D>(sO, dctx + row0 * H + head * dh, q0, S, H, dh);
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
  const float rla = __frcp_rn(la), rlb = __frcp_rn(lb);
  const int n_kt = (S + ROWS - 1) / ROWS;

  // sweep 1: di = rowsum(dp * p)
  float da = 0.f, db = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<D>(sK, k_src, kt * ROWS, S, ld, dh);
    load_tile<D>(sV, v_src, kt * ROWS, S, ld, dh);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float sc[2][4], dp[2][4];
      dot_nt16<D>(sc, qf, sK + ks * 16 * LD, lane);
      dot_nt16<D>(dp, of, sV + ks * 16 * LD, lane);
      chunk_probs(sc, dp, sM, sKeep, kstride, ra, kt * ROWS + ks * 16, S,
                  qma, qmb, ma, mb, la, lb, rla, rlb, sm_scale, drop, t4);
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
    load_tile<D>(sK, k_src, kt * ROWS, S, ld, dh);
    load_tile<D>(sV, v_src, kt * ROWS, S, ld, dh);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float sc[2][4], dp[2][4];
      dot_nt16<D>(sc, qf, sK + ks * 16 * LD, lane);
      dot_nt16<D>(dp, of, sV + ks * 16 * LD, lane);
      chunk_probs(sc, dp, sM, sKeep, kstride, ra, kt * ROWS + ks * 16, S,
                  qma, qmb, ma, mb, la, lb, rla, rlb, sm_scale, drop, t4);
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
    if (dt * 8 >= dh) continue;  // a padded head's zero columns
    const int col = head * dh + dt * 8 + 2 * t4;
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
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : D == 96 ? 2 : 1)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, int ld,
               const bf16* __restrict__ dctx, const float* __restrict__ mask,
               const float* __restrict__ stats, const float* __restrict__ di,
               bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
               int ld_g, int S, int dh, float sm_scale, DropParams drop) {
  constexpr int LD = Tile<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + Tile<D>::ELEMS;
  bf16* sQ = sV + Tile<D>::ELEMS;
  bf16* sO = sQ + Tile<D>::ELEMS;  // dO
  float* sM = reinterpret_cast<float*>(sO + Tile<D>::ELEMS);
  float* sSt = sM + S;  // per query of the tile: m, l, di, 1 / l
  unsigned* sKeep = reinterpret_cast<unsigned*>(sSt + 4 * ROWS);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * ROWS, head = blockIdx.y, elem = blockIdx.z;
  const int n_heads = gridDim.y;
  const int H = n_heads * dh;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;
  const size_t bhs = (size_t)gridDim.z * n_heads * S;
  const size_t off = row0 * ld + head * dh;
  const bf16* q_src = q + off;
  const bf16* k_src = k + off;
  const bf16* v_src = v + off;
  const bf16* o_src = dctx + row0 * H + head * dh;

  for (int j = threadIdx.x; j < S; j += THREADS) sM[j] = mask[row0 + j];
  load_tile<D>(sK, k_src, k0, S, ld, dh);
  load_tile<D>(sV, v_src, k0, S, ld, dh);
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
    load_tile<D>(sQ, q_src, qt0, S, ld, dh);
    load_tile<D>(sO, o_src, qt0, S, H, dh);
    cp_async_commit();
    for (int j = threadIdx.x; j < ROWS; j += THREADS) {
      const int qr = qt0 + j;
      const bool ok = qr < S;
      sSt[j] = ok ? stats[prow0 + qr] : 0.f;
      sSt[ROWS + j] = ok ? stats[bhs + prow0 + qr] : 1.f;
      sSt[2 * ROWS + j] = ok ? di[prow0 + qr] : 0.f;
      sSt[3 * ROWS + j] = __frcp_rn(sSt[ROWS + j]);
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
          const float p =
              div_row(expf(s - sSt[ql]), sSt[ROWS + ql], sSt[3 * ROWS + ql]);
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
    if (dt * 8 >= dh) continue;  // a padded head's zero columns
    const int col = head * dh + dt * 8 + 2 * t4;
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
  int ld, ld_g, B, S, n_heads, dh;
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
      a.dh, a.sm_scale, a.drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkv_kernel<D><<<grid, THREADS, s2, stream>>>(
      a.q, a.k, a.v, a.ld, a.dctx, a.mask, a.stats, a.di, a.dk, a.dv, a.ld_g,
      a.S, a.dh, a.sm_scale, a.drop);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------------- //
// 3. The wgmma pair: d = 64, S <= 512; d = 96, S <= 256
// -------------------------------------------------------------------- //

template <int NK, int D>
struct BwdShape {
  static constexpr int WORDS = NK / 32;      // keep words of a query row
  static constexpr int KSTRIDE = WORDS | 1;  // odd: rows in other banks
  static constexpr int NQ = (NK + 63) / 64 * 64;  // query rows, whole tiles
  static constexpr int ROWB = D * 2;              // bytes of a row
  static constexpr int QTB = QT * ROWB;           // bytes of a 64-row tile
  // dq at d = 64 (one warpgroup a query tile): 1024-byte alignment slack,
  // K, V, the Q and dO tiles, the key segment ids, the tile's keep table
  static constexpr int DQ_SMEM =
      1024 + 2 * NK * 128 + 2 * QTILE + NK * 4 + QT * KSTRIDE * 4;
  // dq at d = 96 (two warpgroups, a run of query tiles): slack, K, V, two
  // Q and two dO tiles, the key segment ids, the warpgroups' di halves and
  // the dq sums they hand each other (24 f32 a thread), the tile's keep
  // table
  static constexpr int DQ2_SMEM = 1024 + 2 * NK * ROWB + 4 * QTB + NK * 4 +
                                  2 * QT * 4 + 48 * 128 * 4 +
                                  QT * KSTRIDE * 4;
  // dq at d = 64 past 256 keys (two warpgroups, a run of query tiles):
  // slack, K, V, a Q and two dO tiles, the key segment ids, the di halves,
  // the probs each thread parks (NK / 8 f32 from 64-key chunks, rounded
  // down; then the 16 dq sums the warpgroups hand each other), the tile's
  // keep table: 223.75 KB at NK = 512
  static constexpr int DQ64X2_SMEM = 1024 + 2 * NK * 128 + 3 * QTILE +
                                     NK * 4 + 2 * QT * 4 +
                                     2 * (NK / 256) * 32 * 128 * 4 +
                                     QT * KSTRIDE * 4;
  // dkv: slack, two Q and two dO tiles, the K and V tiles, the P and dS
  // tiles (64 x 64), the segment ids, each query's m, l, 1 / l and di, the
  // keep table (2 words a query)
  static constexpr int DKV_SMEM = 1024 + 6 * QTB + 2 * QTILE + NQ * 4 +
                                  4 * NQ * 4 + NQ * 2 * 4;
  // dq blocks an SM runs at d = 64, S <= 256 (registers: NK / 2 probs a
  // thread beside the 32 dq sums; shared memory: two at 256); dkv blocks:
  // as many as an SM's 228 KB holds (1 KB reserved a block), at most three
  // (170 registers a thread at d = 64): three at d = 64 and S <= 256, two
  // at 96 and past 256 keys (79 KB at NK = 512)
  static constexpr int DQ_BLOCKS = NK <= 96 ? 3 : 2;
  static constexpr int DKV_BLOCKS =
      228 * 1024 / (DKV_SMEM + 1024) < 3 ? 228 * 1024 / (DKV_SMEM + 1024)
                                         : 3;
};

// The prob dropout of a W-key fragment x (thread rows ra, ra + 8 of the
// keep table; keys c0 + 8 (i / 4) + 2 t + (i & 1), c0 % W == 0):
// x * inv_keep kept, 0 dropped.
template <int W, bool DROP>
__device__ __forceinline__ void drop_frag(float* x, const unsigned* keep,
                                          int kstride, int ra, int c0, int t4,
                                          float inv_keep) {
  if (!DROP) return;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const unsigned w =
        keep[(ra + ((i & 2) ? 8 : 0)) * kstride + (c0 >> 5) + (i >> 4)];
    const int bit = 8 * ((i >> 2) & 3) + 2 * t4 + (i & 1);
    x[i] = (w >> bit) & 1u ? __fmul_rn(x[i], inv_keep) : 0.f;
  }
}

// p = exp(s - m) / l from the saved statistics: the forward's arithmetic
// on the forward's scores, so the forward's p bit for bit.
template <int N>
__device__ __forceinline__ void rebuild_probs(float* sc, float ma, float mb,
                                              float la, float lb, float rla,
                                              float rlb) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    sc[i] = (i & 2) ? div_row(expf(sc[i] - mb), lb, rlb)
                    : div_row(expf(sc[i] - ma), la, rla);
}

// dq kernel, sweep 1 over a W-key chunk: di += rowsum(drop(dO V^T) * p),
// p[i * PS] the chunk's probs (in registers, or parked in shared memory
// 128 floats apart).
template <int W, bool DROP, int PS = 1>
__device__ __forceinline__ void di_chunk(const float* p,
                                         const unsigned char* sO,
                                         const unsigned char* sVc,
                                         const unsigned* keep, int kstride,
                                         int ra, int c0, int t4,
                                         float inv_keep, float& da,
                                         float& db) {
  float dp[W / 2];
  issue_scores<W>(dp, sO, sVc);
  wgmma_wait<0>();
  fence_acc(dp);
  drop_frag<W, DROP>(dp, keep, kstride, ra, c0, t4, inv_keep);
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    if (i & 2)
      db = fmaf(dp[i], p[i * PS], db);
    else
      da = fmaf(dp[i], p[i * PS], da);
  }
}

// dq kernel, sweep 2 over a W-key chunk: dP again, ds = bf16(p (dp - di)
// sm_scale) packed in registers as the A fragments of acc += ds K; p[i *
// PS] as in di_chunk.  Waits for the product, so the next chunk may reuse
// the fragment registers.
template <int W, bool DROP, int PS = 1>
__device__ __forceinline__ void dq_chunk(float (&acc)[32], const float* p,
                                         const unsigned char* sO,
                                         const unsigned char* sVc,
                                         const unsigned char* sKc,
                                         const unsigned* keep, int kstride,
                                         int ra, int c0, int t4,
                                         float inv_keep, float da, float db,
                                         float sm_scale) {
  float dp[W / 2];
  issue_scores<W>(dp, sO, sVc);
  wgmma_wait<0>();
  fence_acc(dp);
  drop_frag<W, DROP>(dp, keep, kstride, ra, c0, t4, inv_keep);
  unsigned pa[W / 4];
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const float di = (i & 2) ? db : da;
    pa[i / 2] = pack_bf16x2(
        __fmul_rn(__fmul_rn(p[i * PS], __fsub_rn(dp[i], di)), sm_scale),
        __fmul_rn(__fmul_rn(p[(i + 1) * PS], __fsub_rn(dp[i + 1], di)),
                  sm_scale));
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < W / 16; ++j)  // 16 keys of K: 2048 bytes a step
    wgmma_rs_n64(acc, pa + 4 * j, smem_desc(sKc + j * 2048, 512, 64), 1);
  wgmma_commit();
  wgmma_wait<0>();
}

// The dq kernel at d = 64: one block (one warpgroup) per (element, head,
// 64-query tile).  K and V of the head (the window's NK rows), the tile's
// Q and dO in 128-byte-swizzled shared memory; S = Q K^T on the forward's
// own wgmma sequence, p rebuilt in registers (NK / 2 a thread), then over
// 64-key chunks dP = dO V^T twice: once for di, once for ds and dq += ds K
// (ds from registers, the A operand's layout).
template <int NK, bool DROP>
__global__ void __launch_bounds__(128, BwdShape<NK, 64>::DQ_BLOCKS)
    dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, int ld,
                    const bf16* __restrict__ dctx,
                    const float* __restrict__ mask,
                    const float* __restrict__ stats, float* __restrict__ di,
                    bf16* __restrict__ dq, int ld_g, int S, float sm_scale,
                    DropParams drop) {
  using Sh = BwdShape<NK, 64>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + NK * 128;
  unsigned char* sQ = sV + NK * 128;
  unsigned char* sO = sQ + QTILE;  // dO
  float* sM = reinterpret_cast<float*>(sO + QTILE);
  unsigned* keep = reinterpret_cast<unsigned*>(sM + NK);

  const int tid = threadIdx.x, head = blockIdx.y, elem = blockIdx.z;
  const int n_heads = gridDim.y, H = n_heads * WD, q0 = blockIdx.x * QT;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;  // Philox row of query 0
  const size_t bhs = (size_t)gridDim.z * n_heads * S;
  const size_t off = row0 * ld + head * WD;
  const float nan = __int_as_float(0x7fc00000);

  // key segment ids (NaN past S: such a key matches no query); Q and K
  // first, so the score product starts while dO and V land
  for (int j = tid; j < NK; j += 128) sM[j] = j < S ? mask[row0 + j] : nan;
  copy_rows(sQ, q + off, ld, q0, QT, S, tid, 128);
  copy_rows(sK, k + off, ld, 0, NK, S, tid, 128);
  cp_async_commit();
  copy_rows(sO, dctx + row0 * H + head * WD, H, q0, QT, S, tid, 128);
  copy_rows(sV, v + off, ld, 0, NK, S, tid, 128);
  cp_async_commit();
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();
  float sc[NK / 2];
  issue_scores<NK>(sc, sQ, sK);
  if (DROP)  // the tile's keep bits while the product runs
    build_keep(keep, QT, Sh::WORDS, Sh::KSTRIDE, drop, prow0 + q0, 0, tid,
               128);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  wgmma_wait<0>();
  fence_acc(sc);

  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = (tid >> 5) * 16 + g, qa = q0 + ra, qb = qa + 8;
  // a query row past S matches no key, and m = 0 makes its p 0
  const float qma = qa < S ? sM[qa] : nan, qmb = qb < S ? sM[qb] : nan;
  const float ma = qa < S ? stats[prow0 + qa] : 0.f;
  const float mb = qb < S ? stats[prow0 + qb] : 0.f;
  const float la = qa < S ? stats[bhs + prow0 + qa] : 1.f;
  const float lb = qb < S ? stats[bhs + prow0 + qb] : 1.f;
  float xa = -INFINITY, xb = -INFINITY;  // row maxima: the saved ones serve
  mask_scores<NK>(sc, sM, qma, qmb, sm_scale, t4, xa, xb);
  rebuild_probs<NK / 2>(sc, ma, mb, la, lb, __frcp_rn(la), __frcp_rn(lb));

  // sweep 1: di = rowsum(dp * p)
  float da = 0.f, db = 0.f;
#pragma unroll
  for (int c = 0; c < NK / 64; ++c)
    di_chunk<64, DROP>(sc + 32 * c, sO, sV + c * 8192, keep, Sh::KSTRIDE,
                       ra, 64 * c, t4, drop.inv_keep, da, db);
  if constexpr (NK % 64 != 0)
    di_chunk<32, DROP>(sc + 32 * (NK / 64), sO, sV + (NK / 64) * 8192, keep,
                       Sh::KSTRIDE, ra, 64 * (NK / 64), t4, drop.inv_keep, da,
                       db);
  da = quad_sum(da);
  db = quad_sum(db);
  if (t4 == 0) {
    if (qa < S) di[prow0 + qa] = da;
    if (qb < S) di[prow0 + qb] = db;
  }

  // sweep 2: dq = sum over keys of bf16(p (dp - di) sm_scale) k
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < NK / 64; ++c)
    dq_chunk<64, DROP>(acc, sc + 32 * c, sO, sV + c * 8192, sK + c * 8192,
                       keep, Sh::KSTRIDE, ra, 64 * c, t4, drop.inv_keep, da,
                       db, sm_scale);
  if constexpr (NK % 64 != 0)
    dq_chunk<32, DROP>(acc, sc + 32 * (NK / 64), sO, sV + (NK / 64) * 8192,
                       sK + (NK / 64) * 8192, keep, Sh::KSTRIDE, ra,
                       64 * (NK / 64), t4, drop.inv_keep, da, db, sm_scale);
  fence_acc(acc);
#pragma unroll
  for (int jj = 0; jj < WD / 8; ++jj) {
    const int col = head * WD + jj * 8 + 2 * t4;
    if (qa < S)
      *reinterpret_cast<unsigned*>(dq + (row0 + qa) * ld_g + col) =
          pack_bf16x2(acc[4 * jj], acc[4 * jj + 1]);
    if (qb < S)
      *reinterpret_cast<unsigned*>(dq + (row0 + qb) * ld_g + col) =
          pack_bf16x2(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

// Barrier of the two warpgroups of a d = 96 dq block or a d = 192 block
// (named barrier 3, 256 threads), which they reach from their own code
// paths.
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// One warpgroup's share of a d = 96 dq tile: the keys K0 .. K0 + KW - 1
// (whole 64-key chunks of the forward's window from K0, and its 32-key
// tail), so its scores are the forward's bits; KW = 0 (a 64-key window
// leaves the second warpgroup none) only keeps the barriers and the keep
// table's half.  Both warpgroups draw the tile's keep bits while their
// score products run; each issues dP = dO V^T for its keys while it
// rebuilds their probs, keeps both in registers (KW / 2 each a thread:
// half a window, so dP is computed once, not again for ds as the d = 64
// kernel must), and the halves of di = rowsum(dp * p) meet in sDi (half 0
// + half 1, in that order in both warpgroups); then ds of each of its
// keys is packed in registers before one dq half = ds K (m64n64k16 on
// panel 0, m64n32k16 on panel 1), and the halves meet in sRed: each
// warpgroup sums and stores 48 of dq's 96 columns.
template <int KW, int K0, bool DROP>
__device__ __forceinline__ void dq96_tile(
    const unsigned char* sQt, const unsigned char* sOt,
    const unsigned char* sK, const unsigned char* sK1,
    const unsigned char* sV, const unsigned char* sV1, const float* sM,
    unsigned* keep, int kstride, int words, float* sDi, float* sRed,
    const float* __restrict__ stats, float* __restrict__ di,
    bf16* __restrict__ dq, size_t row0, int prow0, size_t bhs, int ld_g,
    int col0, int q0, int S, float sm_scale, const DropParams& drop) {
  // D, this warpgroup's index (the second's keys start past 0), its
  // probs and dP a thread
  constexpr int D = 96, WG = K0 > 0, N = KW > 0 ? KW / 2 : 1;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = (tid >> 5) * 16 + g, qa = q0 + ra, qb = qa + 8;
  const float nan = __int_as_float(0x7fc00000);
  float sc[N], dp[N], acc[D / 2];
  if constexpr (KW > 0)
    issue_scores<KW, D>(sc, sQt, fresh(sK) + K0 * 128, fresh(sK1) + K0 * 64);
  if (DROP)  // the tile's keep bits while the products run
    build_keep(keep, QT, words, kstride, drop, prow0 + q0, 0, threadIdx.x,
               256);
  // a query row past S matches no key, and m = 0 makes its p 0
  const float qma = qa < S ? sM[qa] : nan, qmb = qb < S ? sM[qb] : nan;
  const float ma = qa < S ? stats[prow0 + qa] : 0.f;
  const float mb = qb < S ? stats[prow0 + qb] : 0.f;
  const float la = qa < S ? stats[bhs + prow0 + qa] : 1.f;
  const float lb = qb < S ? stats[bhs + prow0 + qb] : 1.f;
  float da = 0.f, db = 0.f;
  if constexpr (KW > 0) {
    wgmma_wait<0>();
    fence_acc(sc);
    // dP = dO V^T for these keys, on the scores' chunks, while p is
    // rebuilt
    issue_scores<KW, D>(dp, sOt, fresh(sV) + K0 * 128, fresh(sV1) + K0 * 64);
    float xa = -INFINITY, xb = -INFINITY;  // row maxima: the saved ones
    mask_scores<KW>(sc, sM + K0, qma, qmb, sm_scale, t4, xa, xb);
    rebuild_probs<KW / 2>(sc, ma, mb, la, lb, __frcp_rn(la), __frcp_rn(lb));
  }
  pair_sync();  // the keep table is complete
  if constexpr (KW > 0) {
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int c = 0; c < KW / 64; ++c)
      drop_frag<64, DROP>(dp + 32 * c, keep, kstride, ra, K0 + 64 * c, t4,
                          drop.inv_keep);
    if constexpr (KW % 64 != 0)
      drop_frag<32, DROP>(dp + 32 * (KW / 64), keep, kstride, ra,
                          K0 + KW - 32, t4, drop.inv_keep);
#pragma unroll
    for (int i = 0; i < KW / 2; ++i) {
      if (i & 2)
        db = fmaf(dp[i], sc[i], db);
      else
        da = fmaf(dp[i], sc[i], da);
    }
    da = quad_sum(da);
    db = quad_sum(db);
  }
  if (t4 == 0) {
    sDi[WG * QT + ra] = da;
    sDi[WG * QT + ra + 8] = db;
  }
  pair_sync();
  da = sDi[ra] + sDi[QT + ra];
  db = sDi[ra + 8] + sDi[QT + ra + 8];
  if (WG == 0 && t4 == 0) {
    if (qa < S) di[prow0 + qa] = da;
    if (qb < S) di[prow0 + qb] = db;
  }
  if constexpr (KW > 0) {
    // ds = bf16(p (dp - di) sm_scale) of every key, packed as the A
    // fragments of the dq half = ds K
    unsigned dsa[KW / 4];
#pragma unroll
    for (int i = 0; i < KW / 2; i += 2) {
      const float dd = (i & 2) ? db : da;
      dsa[i / 2] = pack_bf16x2(
          __fmul_rn(__fmul_rn(sc[i], __fsub_rn(dp[i], dd)), sm_scale),
          __fmul_rn(__fmul_rn(sc[i + 1], __fsub_rn(dp[i + 1], dd)),
                    sm_scale));
    }
    const unsigned char* sKp = fresh(sK) + K0 * 128;
    const unsigned char* sK1p = fresh(sK1) + K0 * 64;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KW / 16; ++j)  // 16 keys of K: 2048 bytes a step
      wgmma_rs_n64(acc, dsa + 4 * j, smem_desc(sKp + j * 2048, 512, 64), j);
#pragma unroll
    for (int j = 0; j < KW / 16; ++j)  // panel 1: 1024 bytes a step
      wgmma_rs_n32(acc + 32, dsa + 4 * j,
                   smem_desc64(sK1p + j * 1024, 1, 32), j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  } else {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  }
  // the halves meet: each warpgroup hands the other the dq sums of the
  // columns it does not store (the first stores columns 0-47, the second
  // 48-95) and adds the other's to its own (a + b: the same bits either
  // way round)
  constexpr int HALF = D / 4;  // 24 sums a thread: columns 0-47 or 48-95
  constexpr int mine = WG * HALF, theirs = HALF - mine;
#pragma unroll
  for (int j = 0; j < HALF; ++j)
    sRed[(WG * HALF + j) * 128 + tid] = acc[theirs + j];
  pair_sync();
#pragma unroll
  for (int j = 0; j < HALF; ++j)
    acc[mine + j] += sRed[((1 - WG) * HALF + j) * 128 + tid];
#pragma unroll
  for (int jj = 0; jj < D / 16; ++jj) {
    const int j4 = mine + 4 * jj;
    const int col = col0 + 2 * j4 + 2 * t4;
    if (qa < S)
      *reinterpret_cast<unsigned*>(dq + (row0 + qa) * ld_g + col) =
          pack_bf16x2(acc[j4], acc[j4 + 1]);
    if (qb < S)
      *reinterpret_cast<unsigned*>(dq + (row0 + qb) * ld_g + col) =
          pack_bf16x2(acc[j4 + 2], acc[j4 + 3]);
  }
}

// The dq kernel at d = 96: one block per (element, head) and a run of its
// 64-query tiles, its two warpgroups sharing the head's K and V (NK rows,
// both panels: 96 KB at S = 256, so one block an SM, which then issues
// the elementwise work from 8 warps) and each tile, whose keys they split
// (dq96_tile: the first warpgroup the first half of the window's 64-key
// chunks).  The next tile's Q and dO are copied into the other buffers
// while this one computes.
template <int NK, bool DROP>
__global__ void __launch_bounds__(256, 1)
    dq96_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, int ld,
                      const bf16* __restrict__ dctx,
                      const float* __restrict__ mask,
                      const float* __restrict__ stats, float* __restrict__ di,
                      bf16* __restrict__ dq, int ld_g, int S, int tpb,
                      float sm_scale, DropParams drop) {
  constexpr int D = 96;
  using Sh = BwdShape<NK, D>;
  // the first warpgroup's keys: the first half of the 64-key chunks
  // (rounded up), the second's the rest and the 32-key tail
  constexpr int KW0 = (NK / 64 + 1) / 2 * 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + NK * Sh::ROWB;
  unsigned char* sQ = sV + NK * Sh::ROWB;  // Q, Q, dO, dO
  unsigned char* sO = sQ + 2 * Sh::QTB;
  float* sM = reinterpret_cast<float*>(sO + 2 * Sh::QTB);
  float* sDi = sM + NK;          // each warpgroup's half of di, per row
  float* sRed = sDi + 2 * QT;    // the dq sums they hand each other
  unsigned* keep = reinterpret_cast<unsigned*>(sRed + (D / 2) * 128);

  const int head = blockIdx.y, elem = blockIdx.z, n_heads = gridDim.y;
  const int H = n_heads * D;
  const int t_end = min((S + QT - 1) / QT, (int)(blockIdx.x + 1) * tpb);
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;  // Philox row of query 0
  const size_t bhs = (size_t)gridDim.z * n_heads * S;
  const size_t off = row0 * ld + head * D;
  const bf16* o_src = dctx + row0 * H + head * D;
  int t = blockIdx.x * tpb;

  // key segment ids (NaN past S: such a key matches no query), K, V and
  // the first tile's Q and dO
  for (int j = threadIdx.x; j < NK; j += 256)
    sM[j] = j < S ? mask[row0 + j] : __int_as_float(0x7fc00000);
  copy_rows<D>(sK, k + off, ld, 0, NK, S, threadIdx.x, 256);
  copy_rows<D>(sV, v + off, ld, 0, NK, S, threadIdx.x, 256);
  copy_rows<D>(sQ, q + off, ld, t * QT, QT, S, threadIdx.x, 256);
  copy_rows<D>(sO, o_src, H, t * QT, QT, S, threadIdx.x, 256);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  for (int i = 0; t < t_end; ++i, ++t) {
    const unsigned char* sQt = sQ + (i & 1) * Sh::QTB;
    const unsigned char* sOt = sO + (i & 1) * Sh::QTB;
    if (t + 1 < t_end) {  // the next tile's Q and dO into the other buffers
      copy_rows<D>(sQ + ((i + 1) & 1) * Sh::QTB, q + off, ld, (t + 1) * QT,
                   QT, S, threadIdx.x, 256);
      copy_rows<D>(sO + ((i + 1) & 1) * Sh::QTB, o_src, H, (t + 1) * QT, QT,
                   S, threadIdx.x, 256);
    }
    cp_async_commit();
#define NBK_DQ96_TILE(KW, K0)                                                 \
  dq96_tile<KW, K0, DROP>(sQt, sOt, sK, sK + NK * 128, sV, sV + NK * 128, sM, \
                          keep, Sh::KSTRIDE, Sh::WORDS, sDi, sRed, stats, di, \
                          dq, row0, prow0, bhs, ld_g, head * D, t * QT, S,    \
                          sm_scale, drop)
    if (threadIdx.x < 128)
      NBK_DQ96_TILE(KW0, 0);
    else
      NBK_DQ96_TILE(NK - KW0, KW0);
#undef NBK_DQ96_TILE
    // the next tile's Q and dO have landed; this tile's buffers, keep
    // table, sDi and sPk are free
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
  }
}

// The dq kernel at d = 64 past 256 keys (NK = 384 or 512: S rounded up
// to 128): one block per (element, head) and a run of its 64-query tiles,
// its two warpgroups sharing the head's K and V (NK rows, 128 KB at S =
// 512, so one block an SM, which then issues the elementwise work from 8
// warps) and each tile, whose keys they split in halves of whole 64-key
// chunks: warpgroup w takes keys w NK / 2 .. (w + 1) NK / 2 - 1, NK / 4
// probs a thread, what the one-warpgroup kernel holds at 256 keys.  It
// keeps the first of its chunks' probs in registers and parks the last
// half of its chunks (rounded down) in shared memory (sPk): those are
// rebuilt first, from their own score product, and the sweeps read them
// from there in their turn.  Per 64-key chunk it issues dP twice, for di
// and then for ds and dq += ds K (di_chunk, dq_chunk), as the
// one-warpgroup kernel does.  Register pressure set this shape: at 512
// keys, with every prob in registers or one chunk parked, ptxas spilled
// the dropout instance (and serialized its wgmma); half parked, it takes
// 234 registers.  Q is read by the score products alone, so one Q buffer,
// refilled once both warpgroups' products are done, leaves room for the
// parked probs (223.75 KB at 512 keys); the dO tiles stay double-buffered.
// The halves of di meet in sDi, those of dq in the parking slots (the
// first warpgroup sums and stores columns 0-31, the second 32-63).  Both
// warpgroups run one code path: a half is an offset into K, V, the
// segment ids and the keep table, not a template argument, so no wgmma is
// issued on a divergent path.
template <int NK, bool DROP>
__global__ void __launch_bounds__(256, 1)
    dq64x2_wgmma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, int ld,
                        const bf16* __restrict__ dctx,
                        const float* __restrict__ mask,
                        const float* __restrict__ stats,
                        float* __restrict__ di, bf16* __restrict__ dq,
                        int ld_g, int S, int tpb, float sm_scale,
                        DropParams drop) {
  using Sh = BwdShape<NK, WD>;
  // a warpgroup's keys, its 64-key chunks whose probs stay in registers,
  // and those it parks (the last, half of them rounded down)
  constexpr int KW = NK / 2, PC = KW / 128, RC = KW / 64 - PC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + NK * 128;
  unsigned char* sQ = sV + NK * 128;  // Q, then dO, dO
  unsigned char* sO = sQ + QTILE;
  float* sM = reinterpret_cast<float*>(sO + 2 * QTILE);
  float* sDi = sM + NK;        // each warpgroup's half of di, per row
  float* sPk = sDi + 2 * QT;   // parked probs: 32 PC a thread, j * 128 + tid
  unsigned* keep = reinterpret_cast<unsigned*>(sPk + 2 * 32 * PC * 128);

  const int head = blockIdx.y, elem = blockIdx.z, n_heads = gridDim.y;
  const int H = n_heads * WD;
  const int t_end = min((S + QT - 1) / QT, (int)(blockIdx.x + 1) * tpb);
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;  // Philox row of query 0
  const size_t bhs = (size_t)gridDim.z * n_heads * S;
  const size_t off = row0 * ld + head * WD;
  const bf16* o_src = dctx + row0 * H + head * WD;
  const float nan = __int_as_float(0x7fc00000);
  int t = blockIdx.x * tpb;

  // key segment ids (NaN past S: such a key matches no query), K, V and
  // the first tile's Q and dO
  for (int j = threadIdx.x; j < NK; j += 256)
    sM[j] = j < S ? mask[row0 + j] : nan;
  copy_rows(sK, k + off, ld, 0, NK, S, threadIdx.x, 256);
  copy_rows(sV, v + off, ld, 0, NK, S, threadIdx.x, 256);
  copy_rows(sQ, q + off, ld, t * QT, QT, S, threadIdx.x, 256);
  copy_rows(sO, o_src, H, t * QT, QT, S, threadIdx.x, 256);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = (tid >> 5) * 16 + g;
  const int k0 = wg * KW;  // this warpgroup's first key
  const int kp = k0 + 64 * RC;  // its first parked key
  // this thread's parking slots (which later carry the dq sums it hands
  // its partner)
  float* park = sPk + wg * 32 * PC * 128 + tid;
  for (int i = 0; t < t_end; ++i, ++t) {
    const unsigned char* sOt = sO + (i & 1) * QTILE;
    if (t + 1 < t_end)  // the next tile's dO into the other buffer
      copy_rows(sO + ((i + 1) & 1) * QTILE, o_src, H, (t + 1) * QT, QT, S,
                threadIdx.x, 256);
    cp_async_commit();
    const int q0 = t * QT, qa = q0 + ra, qb = qa + 8;
    // a query row past S matches no key, and m = 0 makes its p 0
    const float qma = qa < S ? sM[qa] : nan, qmb = qb < S ? sM[qb] : nan;
    const float ma = qa < S ? stats[prow0 + qa] : 0.f;
    const float mb = qb < S ? stats[prow0 + qb] : 0.f;
    const float la = qa < S ? stats[bhs + prow0 + qa] : 1.f;
    const float lb = qb < S ? stats[bhs + prow0 + qb] : 1.f;
    const float rla = __frcp_rn(la), rlb = __frcp_rn(lb);
    {  // the parked chunks' probs, first
      float sp[32 * PC];
      issue_scores<64 * PC>(sp, sQ, fresh(sK) + kp * 128);
      if (DROP)  // the tile's keep bits while the product runs
        build_keep(keep, QT, Sh::WORDS, Sh::KSTRIDE, drop, prow0 + q0, 0,
                   threadIdx.x, 256);
      wgmma_wait<0>();
      fence_acc(sp);
      float xa = -INFINITY, xb = -INFINITY;  // row maxima: the saved ones
      mask_scores<64 * PC>(sp, sM + kp, qma, qmb, sm_scale, t4, xa, xb);
      rebuild_probs<32 * PC>(sp, ma, mb, la, lb, rla, rlb);
#pragma unroll
      for (int j = 0; j < 32 * PC; ++j) park[j * 128] = sp[j];
    }
    float sc[32 * RC];
    issue_scores<64 * RC>(sc, sQ, fresh(sK) + k0 * 128);
    wgmma_wait<0>();
    fence_acc(sc);
    float xa = -INFINITY, xb = -INFINITY;
    mask_scores<64 * RC>(sc, sM + k0, qma, qmb, sm_scale, t4, xa, xb);
    rebuild_probs<32 * RC>(sc, ma, mb, la, lb, rla, rlb);
    __syncthreads();  // the keep table is complete; Q is read
    if (t + 1 < t_end)  // the next tile's Q
      copy_rows(sQ, q + off, ld, (t + 1) * QT, QT, S, threadIdx.x, 256);
    cp_async_commit();

    // sweep 1: this half of di = rowsum(dp * p)
    float da = 0.f, db = 0.f;
#pragma unroll
    for (int c = 0; c < RC; ++c)
      di_chunk<64, DROP>(sc + 32 * c, sOt, fresh(sV) + (k0 + 64 * c) * 128,
                         keep, Sh::KSTRIDE, ra, k0 + 64 * c, t4,
                         drop.inv_keep, da, db);
#pragma unroll
    for (int c = 0; c < PC; ++c)
      di_chunk<64, DROP, 128>(park + 32 * c * 128, sOt,
                              fresh(sV) + (kp + 64 * c) * 128, keep,
                              Sh::KSTRIDE, ra, kp + 64 * c, t4,
                              drop.inv_keep, da, db);
    da = quad_sum(da);
    db = quad_sum(db);
    if (t4 == 0) {
      sDi[wg * QT + ra] = da;
      sDi[wg * QT + ra + 8] = db;
    }
    __syncthreads();
    da = sDi[ra] + sDi[QT + ra];
    db = sDi[ra + 8] + sDi[QT + ra + 8];
    if (wg == 0 && t4 == 0) {
      if (qa < S) di[prow0 + qa] = da;
      if (qb < S) di[prow0 + qb] = db;
    }

    // sweep 2: this half of dq = sum over its keys of bf16(p (dp - di)
    // sm_scale) k
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
#pragma unroll
    for (int c = 0; c < RC; ++c)
      dq_chunk<64, DROP>(acc, sc + 32 * c, sOt,
                         fresh(sV) + (k0 + 64 * c) * 128,
                         fresh(sK) + (k0 + 64 * c) * 128, keep, Sh::KSTRIDE,
                         ra, k0 + 64 * c, t4, drop.inv_keep, da, db,
                         sm_scale);
#pragma unroll
    for (int c = 0; c < PC; ++c)
      dq_chunk<64, DROP, 128>(acc, park + 32 * c * 128, sOt,
                              fresh(sV) + (kp + 64 * c) * 128,
                              fresh(sK) + (kp + 64 * c) * 128, keep,
                              Sh::KSTRIDE, ra, kp + 64 * c, t4,
                              drop.inv_keep, da, db, sm_scale);
    fence_acc(acc);
    // the halves meet: each thread hands its partner in the other
    // warpgroup (the same fragment) the sums of the columns it does not
    // store -- acc[4 jj + e] is column 8 jj + 2 t (+ 1) -- in its own
    // parking slots, and adds the partner's to its own (a + b: the same
    // bits either way round); selects, not an index by wg, keep acc in
    // registers
#pragma unroll
    for (int j = 0; j < 16; ++j) park[j * 128] = wg ? acc[j] : acc[16 + j];
    __syncthreads();
    const float* theirs = sPk + (1 - wg) * 32 * PC * 128 + tid;
    float mine[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mine[j] = (wg ? acc[16 + j] : acc[j]) + theirs[j * 128];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = head * WD + (4 * wg + jj) * 8 + 2 * t4;
      if (qa < S)
        *reinterpret_cast<unsigned*>(dq + (row0 + qa) * ld_g + col) =
            pack_bf16x2(mine[4 * jj], mine[4 * jj + 1]);
      if (qb < S)
        *reinterpret_cast<unsigned*>(dq + (row0 + qb) * ld_g + col) =
            pack_bf16x2(mine[4 * jj + 2], mine[4 * jj + 3]);
    }
    // the next tile's Q and dO have landed; this tile's dO buffer, keep
    // table, sDi and sPk are free
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
  }
}

// The dkv kernel's loop over the head's query tiles for its W keys (64,
// or 32 for the window's last 32 when NK % 64 == 32, whose scores the
// forward takes from an m64n32k16 product).  Per tile: S and dP on the
// forward's wgmma sequence with the tile's queries as rows, p rebuilt,
// drop(p) and ds rounded to bf16 into the swizzled sP and sS tiles (query
// rows, key columns), then dV += drop(p)^T dO and dK += ds^T Q with both
// operands MN-major in shared memory (at D = 96 columns 64-95 as m64n32k16
// from the tiles' 64-byte panels); the next tile's Q and dO are copied
// into the other buffer meanwhile.  A key past W only reaches its own
// output row (never stored), so sP and sS need no clearing.
template <int W, int D, bool DROP>
__device__ __forceinline__ void dkv_tiles(
    float (&dk)[D / 2], float (&dv)[D / 2], const bf16* q_src, int ld,
    const bf16* o_src, int ld_o, unsigned char* sQ, unsigned char* sO,
    const unsigned char* sK, const unsigned char* sV, unsigned char* sP,
    unsigned char* sS, const float* sM, const float* sSt, int nq,
    const unsigned* keep, int k0, int S, float sm_scale,
    const DropParams& drop) {
  constexpr int QTB = BwdShape<64, D>::QTB;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = (tid >> 5) * 16 + g;
  const float nan = __int_as_float(0x7fc00000);
  const int n_qt = nq / QT;
  for (int qt = 0; qt < n_qt; ++qt) {
    const unsigned char* sQt = sQ + (qt & 1) * QTB;
    const unsigned char* sOt = sO + (qt & 1) * QTB;
    float s[W / 2], dp[W / 2];
    issue_scores<W, D>(s, sQt, sK, sK + QT * 128);
    issue_scores<W, D>(dp, sOt, sV, sV + QT * 128);
    const int qa = qt * QT + ra, qb = qa + 8;
    const float qma = qa < S ? sM[qa] : nan, qmb = qb < S ? sM[qb] : nan;
    wgmma_wait<0>();  // also the last tile's dV / dK products
    fence_acc(s);
    fence_acc(dp);
    // every warp's share of the last products (which read sP, sS and the
    // other Q / dO buffer) is done: copy the next tile there
    __syncthreads();
    if (qt + 1 < n_qt) {
      copy_rows<D>(sQ + ((qt + 1) & 1) * QTB, q_src, ld, (qt + 1) * QT, QT,
                   S, tid, 128);
      copy_rows<D>(sO + ((qt + 1) & 1) * QTB, o_src, ld_o, (qt + 1) * QT,
                   QT, S, tid, 128);
    }
    cp_async_commit();
    float xa = -INFINITY, xb = -INFINITY;  // unused row maxima
    mask_scores<W>(s, sM + k0, qma, qmb, sm_scale, t4, xa, xb);
    rebuild_probs<W / 2>(s, sSt[qa], sSt[qb], sSt[nq + qa], sSt[nq + qb],
                         sSt[2 * nq + qa], sSt[2 * nq + qb]);
    const float dia = sSt[3 * nq + qa], dib = sSt[3 * nq + qb];
#pragma unroll
    for (int jj = 0; jj < W / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = 4 * jj + e;
        const float di = e ? dib : dia;
        float p0 = s[i], p1 = s[i + 1], d0 = dp[i], d1 = dp[i + 1];
        if (DROP) {  // keys 8 jj + 2 t, + 1 of rows qa / qb
          const unsigned w = keep[(qa + (e ? 8 : 0)) * 2 + (jj >> 2)] >>
                             (8 * (jj & 3) + 2 * t4);
          p0 = (w & 1u) ? __fmul_rn(p0, drop.inv_keep) : 0.f;
          d0 = (w & 1u) ? __fmul_rn(d0, drop.inv_keep) : 0.f;
          p1 = (w & 2u) ? __fmul_rn(p1, drop.inv_keep) : 0.f;
          d1 = (w & 2u) ? __fmul_rn(d1, drop.inv_keep) : 0.f;
        }
        const int off = swizzle128(ra + 4 * e, jj) + 4 * t4;
        *reinterpret_cast<unsigned*>(sP + off) = pack_bf16x2(p0, p1);
        *reinterpret_cast<unsigned*>(sS + off) = pack_bf16x2(
            __fmul_rn(__fmul_rn(s[i], __fsub_rn(d0, di)), sm_scale),
            __fmul_rn(__fmul_rn(s[i + 1], __fsub_rn(d1, di)), sm_scale));
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < QT / 16; ++j)  // 16 queries: 2048 bytes a step
      wgmma_tt_n64(dv, smem_desc(sP + j * 2048, 512, 64),
                   smem_desc(sOt + j * 2048, 512, 64), qt > 0 || j > 0);
    if constexpr (D == 96) {
#pragma unroll
      for (int j = 0; j < QT / 16; ++j)  // panel 1: 1024 bytes a step
        wgmma_tt_n32(dv + 32, smem_desc(sP + j * 2048, 512, 64),
                     smem_desc64(sOt + QT * 128 + j * 1024, 1, 32),
                     qt > 0 || j > 0);
    }
#pragma unroll
    for (int j = 0; j < QT / 16; ++j)
      wgmma_tt_n64(dk, smem_desc(sS + j * 2048, 512, 64),
                   smem_desc(sQt + j * 2048, 512, 64), qt > 0 || j > 0);
    if constexpr (D == 96) {
#pragma unroll
      for (int j = 0; j < QT / 16; ++j)
        wgmma_tt_n32(dk + 32, smem_desc(sS + j * 2048, 512, 64),
                     smem_desc64(sQt + QT * 128 + j * 1024, 1, 32),
                     qt > 0 || j > 0);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_acc(dk);
  fence_acc(dv);
}

// The dkv kernel: one block (one warpgroup) per (element, head, 64-key
// tile), keys as the rows of dK and dV.  The block's K and V tiles and
// each query's m, l, 1 / l and di (from the dq kernel) are loaded once,
// the head's Q and dO a tile at a time into two buffers.
template <int NK, int D, bool DROP>
__global__ void __launch_bounds__(128, BwdShape<NK, D>::DKV_BLOCKS)
    dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, int ld,
                     const bf16* __restrict__ dctx,
                     const float* __restrict__ mask,
                     const float* __restrict__ stats,
                     const float* __restrict__ di, bf16* __restrict__ dk_out,
                     bf16* __restrict__ dv_out, int ld_g, int S,
                     float sm_scale, DropParams drop) {
  using Sh = BwdShape<NK, D>;
  constexpr int NQ = Sh::NQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sO = sQ + 2 * Sh::QTB;  // dO
  unsigned char* sK = sO + 2 * Sh::QTB;
  unsigned char* sV = sK + Sh::QTB;
  unsigned char* sP = sV + Sh::QTB;   // drop(p), bf16
  unsigned char* sS = sP + QTILE;     // ds, bf16
  float* sM = reinterpret_cast<float*>(sS + QTILE);
  float* sSt = sM + NQ;  // m, l, 1 / l, di of each query
  unsigned* keep = reinterpret_cast<unsigned*>(sSt + 4 * NQ);

  const int tid = threadIdx.x, head = blockIdx.y, elem = blockIdx.z;
  const int n_heads = gridDim.y, H = n_heads * D, k0 = blockIdx.x * QT;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;
  const size_t bhs = (size_t)gridDim.z * n_heads * S;
  const size_t off = row0 * ld + head * D;
  const int nq = (S + QT - 1) / QT * QT;
  const bf16* o_src = dctx + row0 * H + head * D;

  copy_rows<D>(sQ, q + off, ld, 0, QT, S, tid, 128);
  copy_rows<D>(sO, o_src, H, 0, QT, S, tid, 128);
  copy_rows<D>(sK, k + off, ld, k0, QT, S, tid, 128);
  copy_rows<D>(sV, v + off, ld, k0, QT, S, tid, 128);
  cp_async_commit();
  // rows past S: m = 0, l = 1, di = 0 (their p is 0, their dO rows 0)
  for (int j = tid; j < nq; j += 128) {
    const bool ok = j < S;
    const float l = ok ? stats[bhs + prow0 + j] : 1.f;
    sM[j] = ok ? mask[row0 + j] : __int_as_float(0x7fc00000);
    sSt[j] = ok ? stats[prow0 + j] : 0.f;
    sSt[nq + j] = l;
    sSt[2 * nq + j] = __frcp_rn(l);
    sSt[3 * nq + j] = ok ? di[prow0 + j] : 0.f;
  }
  for (int j = nq + tid; j < NQ; j += 128)  // keys of the last key tile
    sM[j] = __int_as_float(0x7fc00000);
  // keep bits of every query against this block's 64 keys: row q, word w
  // = keys k0 + 32 w ..
  if (DROP) build_keep(keep, S, 2, 2, drop, prow0, k0, tid, 128);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float dk[D / 2], dv[D / 2];  // the first query tile's first product sets
                               // them
  const bf16* q_src = q + off;
#define NBK_DKV_TILES(W)                                                    \
  dkv_tiles<W, D, DROP>(dk, dv, q_src, ld, o_src, H, sQ, sO, sK, sV, sP, sS, \
                        sM, sSt, nq, keep, k0, S, sm_scale, drop)
  if constexpr (NK % 64 != 0) {
    if (k0 + QT > NK)
      NBK_DKV_TILES(32);
    else
      NBK_DKV_TILES(64);
  } else {
    NBK_DKV_TILES(64);
  }
#undef NBK_DKV_TILES

  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ka = k0 + (tid >> 5) * 16 + g, kb = ka + 8;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = head * D + jj * 8 + 2 * t4;
    if (ka < S) {
      const size_t r = (row0 + ka) * ld_g + col;
      *reinterpret_cast<unsigned*>(dk_out + r) =
          pack_bf16x2(dk[4 * jj], dk[4 * jj + 1]);
      *reinterpret_cast<unsigned*>(dv_out + r) =
          pack_bf16x2(dv[4 * jj], dv[4 * jj + 1]);
    }
    if (kb < S) {
      const size_t r = (row0 + kb) * ld_g + col;
      *reinterpret_cast<unsigned*>(dk_out + r) =
          pack_bf16x2(dk[4 * jj + 2], dk[4 * jj + 3]);
      *reinterpret_cast<unsigned*>(dv_out + r) =
          pack_bf16x2(dv[4 * jj + 2], dv[4 * jj + 3]);
    }
  }
}

// -------------------------------------------------------------------- //
// 4. The wgmma pair at d = 192, S <= 256
// -------------------------------------------------------------------- //

template <int NK>
struct Bwd192 {
  static constexpr int D = 192;
  static constexpr int ROWB = D * 2;          // bytes of a row, 3 panels
  static constexpr int QTB = QT * ROWB;       // bytes of a 64-row tile
  static constexpr int NQ = (NK + 63) / 64 * 64;
  static constexpr int WORDS = NK / 32;       // keep words of a query row
  static constexpr int KSTRIDE = WORDS | 1;   // odd: rows in other banks
  // the dq kernel's first warpgroup's keys: the first half of the
  // window's 64-key chunks (rounded up); the second takes the rest and
  // the 32-key tail
  static constexpr int KW0 = (NK / 64 + 1) / 2 * 64;
  // dq: 1024-byte alignment slack, K, the Q and dO tiles, a 64-key V slot
  // a warpgroup (which then carry the dq sums the warpgroups hand each
  // other, 48 f32 a thread), the key segment ids, the di halves, the
  // tile's keep table: 196.75 KB at NK = 256
  static constexpr int DQ_SMEM = 1024 + NK * ROWB + 4 * QTB + NK * 4 +
                                 2 * QT * 4 + QT * KSTRIDE * 4;
  // dkv: slack, two Q and two dO tiles, the K and V tiles, the P and dS
  // tiles (bf16 64 x 64), p (f32 64 x 64), the segment ids, each query's
  // m, l, 1 / l and di, the keep table (2 words a query): 184 KB
  static constexpr int DKV_SMEM = 1024 + 6 * QTB + 2 * QTILE + QT * QT * 4 +
                                  NQ * 4 + 4 * NQ * 4 + NQ * 2 * 4;
};

// One warpgroup's part of a d = 192 dq block (WG 0: keys 0 .. KW0 - 1,
// WG 1: KW0 .. NK - 1; whole 64-key chunks of the forward's window from
// its first key, and the 32-key tail, so its scores are the forward's
// bits), over the block's query tiles t0 .. t_end - 1.  Per tile: S = Q
// K^T for its keys from the resident K, p rebuilt in registers; dP = dO
// V^T through its 64-key V slot, one piece of at most 64 keys at a time
// (the first copied while the last tile ended), dropped, kept in
// registers beside p (half a window each: KW / 2 + KW / 2 a thread), so
// dP is computed once; the halves of di = rowsum(dp * p) meet in sDi
// (half 0 + half 1 in both warpgroups); ds packed in registers is the A
// operand of this half's dq = ds K (three m64n64k16 a k16 step, one a
// panel), and the halves meet in sRed, over both V slots: each warpgroup
// sums and stores 96 of dq's 192 columns.  The next tile's Q is copied
// once both score products are done, its dO once both dP products are,
// its first V piece once the sums are read.
template <int NK, int WG, bool DROP>
__device__ __forceinline__ void dq192_role(
    const bf16* __restrict__ q_src, const bf16* __restrict__ v_src,
    const bf16* __restrict__ o_src, int ld, int H, unsigned char* sQ,
    unsigned char* sO, const unsigned char* sK, unsigned char* sVs,
    const float* sM, unsigned* keep, float* sDi,
    const float* __restrict__ stats, float* __restrict__ di,
    bf16* __restrict__ dq, size_t row0, int prow0, size_t bhs, int ld_g,
    int col0, int t0, int t_end, int S, float sm_scale,
    const DropParams& drop) {
  using Sh = Bwd192<NK>;
  constexpr int D = 192;
  constexpr int K0 = WG ? Sh::KW0 : 0, KW = WG ? NK - Sh::KW0 : Sh::KW0;
  // the V pieces' keys (KW <= 128), this thread's probs and dP
  constexpr int W0 = KW < 64 ? KW : 64, W1 = KW - W0;
  constexpr int N = KW > 0 ? KW / 2 : 1;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = (tid >> 5) * 16 + g;
  const float nan = __int_as_float(0x7fc00000);
  unsigned char* slot = sVs + WG * Sh::QTB;
  float* sRed = reinterpret_cast<float*>(sVs);
  for (int t = t0; t < t_end; ++t) {
    const int q0 = t * QT, qa = q0 + ra, qb = qa + 8;
    float sc[N], dp[N], acc[D / 2];
    if constexpr (KW > 0)
      issue_scores<KW, D>(sc, sQ, fresh(sK) + K0 * 128, nullptr, NK * 128);
    if (DROP)  // the tile's keep bits while the products run
      build_keep(keep, QT, Sh::WORDS, Sh::KSTRIDE, drop, prow0 + q0, 0,
                 threadIdx.x, 256);
    // a query row past S matches no key, and m = 0 makes its p 0
    const float qma = qa < S ? sM[qa] : nan, qmb = qb < S ? sM[qb] : nan;
    const float ma = qa < S ? stats[prow0 + qa] : 0.f;
    const float mb = qb < S ? stats[prow0 + qb] : 0.f;
    const float la = qa < S ? stats[bhs + prow0 + qa] : 1.f;
    const float lb = qb < S ? stats[bhs + prow0 + qb] : 1.f;
    if constexpr (KW > 0) {
      wgmma_wait<0>();
      fence_acc(sc);
    }
    pair_sync();  // both score products are done; the keep table is full
    if (t + 1 < t_end)
      copy_rows<D>(sQ, q_src, ld, (t + 1) * QT, QT, S, threadIdx.x, 256);
    cp_async_commit();
    float da = 0.f, db = 0.f;
    if constexpr (KW > 0) {
      float xa = -INFINITY, xb = -INFINITY;  // row maxima: the saved ones
      mask_scores<KW>(sc, sM + K0, qma, qmb, sm_scale, t4, xa, xb);
      rebuild_probs<KW / 2>(sc, ma, mb, la, lb, __frcp_rn(la), __frcp_rn(lb));
      cp_async_wait<1>();  // the first V piece has landed
      fence_proxy_async();
      warpgroup_sync(WG);
      issue_scores<W0, D>(*reinterpret_cast<float(*)[W0 / 2]>(dp), sO,
                          fresh(slot), nullptr, QT * 128);
      wgmma_wait<0>();
      if constexpr (W1 > 0) {
        warpgroup_sync(WG);  // every warp's product has read the slot
        copy_rows<D>(slot, v_src, ld, K0 + 64, QT, S, tid, 128);
        cp_async_commit();
        cp_async_wait<0>();
        fence_proxy_async();
        warpgroup_sync(WG);
        issue_scores<W1, D>(*reinterpret_cast<float(*)[W1 / 2]>(dp + 32), sO,
                            fresh(slot), nullptr, QT * 128);
        wgmma_wait<0>();
      }
      fence_acc(dp);
      drop_frag<W0, DROP>(dp, keep, Sh::KSTRIDE, ra, K0, t4, drop.inv_keep);
      if constexpr (W1 > 0)
        drop_frag<W1, DROP>(dp + 32, keep, Sh::KSTRIDE, ra, K0 + 64, t4,
                            drop.inv_keep);
#pragma unroll
      for (int i = 0; i < KW / 2; ++i) {
        if (i & 2)
          db = fmaf(dp[i], sc[i], db);
        else
          da = fmaf(dp[i], sc[i], da);
      }
      da = quad_sum(da);
      db = quad_sum(db);
    }
    if (t4 == 0) {
      sDi[WG * QT + ra] = da;
      sDi[WG * QT + ra + 8] = db;
    }
    pair_sync();  // di's halves are written; both dP products are done
    da = sDi[ra] + sDi[QT + ra];
    db = sDi[ra + 8] + sDi[QT + ra + 8];
    if (WG == 0 && t4 == 0) {
      if (qa < S) di[prow0 + qa] = da;
      if (qb < S) di[prow0 + qb] = db;
    }
    if (t + 1 < t_end)
      copy_rows<D>(sO, o_src, H, (t + 1) * QT, QT, S, threadIdx.x, 256);
    cp_async_commit();
    if constexpr (KW > 0) {
      // ds = bf16(p (dp - di) sm_scale) of every key, packed as the A
      // fragments of this half's dq = ds K
      unsigned dsa[KW / 4];
#pragma unroll
      for (int i = 0; i < KW / 2; i += 2) {
        const float dd = (i & 2) ? db : da;
        dsa[i / 2] = pack_bf16x2(
            __fmul_rn(__fmul_rn(sc[i], __fsub_rn(dp[i], dd)), sm_scale),
            __fmul_rn(__fmul_rn(sc[i + 1], __fsub_rn(dp[i + 1], dd)),
                      sm_scale));
      }
      const unsigned char* sKp = fresh(sK) + K0 * 128;
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int j = 0; j < KW / 16; ++j)  // 16 keys of K: 2048 bytes
          wgmma_rs_n64(acc + 32 * p, dsa + 4 * j,
                       smem_desc(sKp + p * NK * 128 + j * 2048, 512, 64), j);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    } else {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    }
    // the halves meet: each warpgroup hands the other the dq sums of the
    // columns it does not store (the first stores columns 0-95, the
    // second 96-191) and adds the other's to its own (a + b: the same
    // bits either way round)
    constexpr int HALF = D / 4;  // 48 sums a thread
    constexpr int mine = WG * HALF, theirs = HALF - mine;
#pragma unroll
    for (int j = 0; j < HALF; ++j)
      sRed[(WG * HALF + j) * 128 + tid] = acc[theirs + j];
    pair_sync();
#pragma unroll
    for (int j = 0; j < HALF; ++j)
      acc[mine + j] += sRed[((1 - WG) * HALF + j) * 128 + tid];
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
      const int j4 = mine + 4 * jj;
      const int col = col0 + 2 * j4 + 2 * t4;
      if (qa < S)
        *reinterpret_cast<unsigned*>(dq + (row0 + qa) * ld_g + col) =
            pack_bf16x2(acc[j4], acc[j4 + 1]);
      if (qb < S)
        *reinterpret_cast<unsigned*>(dq + (row0 + qb) * ld_g + col) =
            pack_bf16x2(acc[j4 + 2], acc[j4 + 3]);
    }
    pair_sync();  // the sums are read: the V slots are free
    if (KW > 0 && t + 1 < t_end)
      copy_rows<D>(slot, v_src, ld, K0, QT, S, tid, 128);
    cp_async_commit();
    cp_async_wait<1>();  // the next tile's Q and dO have landed
    fence_proxy_async();
    pair_sync();
  }
}

// The dq kernel at d = 192: one block per (element, head) and a run of its
// 64-query tiles; its two warpgroups keep the head's K (96 KB at S = 256)
// and split each tile's keys (dq192_role).  K and V resident, as at d =
// 96, and a Q and a dO tile would take 240 KB: V passes through a 64-key
// slot a warpgroup instead, read once a tile.
template <int NK, bool DROP>
__global__ void __launch_bounds__(256, 1)
    dq192_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, int ld,
                       const bf16* __restrict__ dctx,
                       const float* __restrict__ mask,
                       const float* __restrict__ stats,
                       float* __restrict__ di, bf16* __restrict__ dq,
                       int ld_g, int S, int tpb, float sm_scale,
                       DropParams drop) {
  constexpr int D = 192;
  using Sh = Bwd192<NK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = sK + NK * Sh::ROWB;
  unsigned char* sO = sQ + Sh::QTB;  // dO
  unsigned char* sVs = sO + Sh::QTB;  // the warpgroups' V slots
  float* sM = reinterpret_cast<float*>(sVs + 2 * Sh::QTB);
  float* sDi = sM + NK;  // each warpgroup's half of di, per row
  unsigned* keep = reinterpret_cast<unsigned*>(sDi + 2 * QT);

  const int head = blockIdx.y, elem = blockIdx.z, n_heads = gridDim.y;
  const int H = n_heads * D;
  const int t0 = blockIdx.x * tpb;
  const int t_end = min((S + QT - 1) / QT, t0 + tpb);
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;  // Philox row of query 0
  const size_t bhs = (size_t)gridDim.z * n_heads * S;
  const size_t off = row0 * ld + head * D;
  const bf16* o_src = dctx + row0 * H + head * D;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;

  // key segment ids (NaN past S: such a key matches no query), K, the
  // first tile's Q and dO; then each warpgroup's first V piece
  for (int j = threadIdx.x; j < NK; j += 256)
    sM[j] = j < S ? mask[row0 + j] : __int_as_float(0x7fc00000);
  copy_rows<D>(sK, k + off, ld, 0, NK, S, threadIdx.x, 256);
  copy_rows<D>(sQ, q + off, ld, t0 * QT, QT, S, threadIdx.x, 256);
  copy_rows<D>(sO, o_src, H, t0 * QT, QT, S, threadIdx.x, 256);
  cp_async_commit();
  if (wg == 0 || NK > Sh::KW0)
    copy_rows<D>(sVs + wg * Sh::QTB, v + off, ld, wg * Sh::KW0, QT, S, tid,
                 128);
  cp_async_commit();
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();
#define NBK_DQ192_ROLE(WG)                                                   \
  dq192_role<NK, WG, DROP>(q + off, v + off, o_src, ld, H, sQ, sO, sK, sVs, \
                           sM, keep, sDi, stats, di, dq, row0, prow0, bhs,  \
                           ld_g, head * D, t0, t_end, S, sm_scale, drop)
  if (wg == 0)
    NBK_DQ192_ROLE(0);
  else
    NBK_DQ192_ROLE(1);
#undef NBK_DQ192_ROLE
}

// One warpgroup's part of a d = 192 dkv block, over the head's query
// tiles for the block's W keys (64, or 32 for the window's last 32 when
// NK % 64 == 32): the first (WG 0) issues S = Q K^T and rebuilds p, hands
// p over in sPf (f32, in its fragment order) and writes drop(p) as bf16
// into sP, then accumulates dV += drop(p)^T dO; the second issues dP =
// dO V^T, drops it, and with the first's p writes ds as bf16 into sS, then
// accumulates dK += ds^T Q (both on the forward's wgmma sequence with the
// tile's queries as rows; the dV and dK products read both operands
// MN-major from shared memory, three m64n64k16 a k16 step).  Each keeps
// one 64 x 192 f32 accumulator, 96 registers a thread, where one
// warpgroup holding both (the 192-wide mma.sync kernel's design) spills.
// The second copies the next tile's Q and dO into the other buffers while
// the first rebuilds p.
template <int WG, int W, bool DROP>
__device__ __forceinline__ void dkv192_role(
    const bf16* __restrict__ q_src, int ld, const bf16* __restrict__ o_src,
    int ld_o, unsigned char* sQ, unsigned char* sO, const unsigned char* sK,
    const unsigned char* sV, unsigned char* sP, unsigned char* sS,
    float* sPf, const float* sM, const float* sSt, int nq,
    const unsigned* keep, int k0, int S, float sm_scale,
    const DropParams& drop, bf16* __restrict__ out, size_t row0, int ld_g,
    int col0) {
  constexpr int D = 192, QTB = Bwd192<64>::QTB;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = (tid >> 5) * 16 + g;
  const float nan = __int_as_float(0x7fc00000);
  const int n_qt = nq / QT;
  float acc[D / 2];  // the first query tile's first product sets it
  for (int qt = 0; qt < n_qt; ++qt) {
    const unsigned char* sQt = sQ + (qt & 1) * QTB;
    const unsigned char* sOt = sO + (qt & 1) * QTB;
    float x[W / 2];  // S (WG 0) or dP (WG 1)
    if constexpr (WG == 0)
      issue_scores<W, D>(x, sQt, fresh(sK), nullptr, QT * 128);
    else
      issue_scores<W, D>(x, sOt, fresh(sV), nullptr, QT * 128);
    const int qa = qt * QT + ra, qb = qa + 8;
    wgmma_wait<0>();  // also the last tile's dV / dK product
    fence_acc(x);
    // both warpgroups' last products (which read sP, sS and the other Q /
    // dO buffer) are done: copy the next tile there -- the dS warpgroup,
    // which waits for p meanwhile
    pair_sync();
    if (WG == 1 && qt + 1 < n_qt) {
      copy_rows<D>(sQ + ((qt + 1) & 1) * QTB, q_src, ld, (qt + 1) * QT, QT,
                   S, tid, 128);
      copy_rows<D>(sO + ((qt + 1) & 1) * QTB, o_src, ld_o, (qt + 1) * QT,
                   QT, S, tid, 128);
    }
    cp_async_commit();
    if constexpr (WG == 0) {
      const float qma = qa < S ? sM[qa] : nan, qmb = qb < S ? sM[qb] : nan;
      float xa = -INFINITY, xb = -INFINITY;  // unused row maxima
      mask_scores<W>(x, sM + k0, qma, qmb, sm_scale, t4, xa, xb);
      rebuild_probs<W / 2>(x, sSt[qa], sSt[qb], sSt[nq + qa], sSt[nq + qb],
                           sSt[2 * nq + qa], sSt[2 * nq + qb]);
#pragma unroll
      for (int i = 0; i < W / 2; ++i) sPf[i * 128 + tid] = x[i];
    }
    pair_sync();  // p is in sPf
#pragma unroll
    for (int jj = 0; jj < W / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = 4 * jj + e;
        const float p0 = WG == 0 ? x[i] : sPf[i * 128 + tid];
        const float p1 = WG == 0 ? x[i + 1] : sPf[(i + 1) * 128 + tid];
        bool k0b = true, k1b = true;
        if (DROP) {  // keys 8 jj + 2 t, + 1 of rows qa / qb
          const unsigned w = keep[(qa + (e ? 8 : 0)) * 2 + (jj >> 2)] >>
                             (8 * (jj & 3) + 2 * t4);
          k0b = w & 1u;
          k1b = w & 2u;
        }
        const int off = swizzle128(ra + 4 * e, jj) + 4 * t4;
        if constexpr (WG == 0) {
          *reinterpret_cast<unsigned*>(sP + off) = pack_bf16x2(
              !DROP ? p0 : k0b ? __fmul_rn(p0, drop.inv_keep) : 0.f,
              !DROP ? p1 : k1b ? __fmul_rn(p1, drop.inv_keep) : 0.f);
        } else {
          const float di = sSt[3 * nq + (e ? qb : qa)];
          const float d0 =
              !DROP ? x[i] : k0b ? __fmul_rn(x[i], drop.inv_keep) : 0.f;
          const float d1 = !DROP    ? x[i + 1]
                           : k1b    ? __fmul_rn(x[i + 1], drop.inv_keep)
                                    : 0.f;
          *reinterpret_cast<unsigned*>(sS + off) = pack_bf16x2(
              __fmul_rn(__fmul_rn(p0, __fsub_rn(d0, di)), sm_scale),
              __fmul_rn(__fmul_rn(p1, __fsub_rn(d1, di)), sm_scale));
        }
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    pair_sync();  // sP and sS are written; the next tile has landed
    const unsigned char* sA = WG == 0 ? sP : sS;    // drop(p) or ds
    const unsigned char* sB = WG == 0 ? sOt : sQt;  // dO or Q
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int j = 0; j < QT / 16; ++j)  // 16 queries: 2048 bytes a step
        wgmma_tt_n64(acc + 32 * p, smem_desc(sA + j * 2048, 512, 64),
                     smem_desc(sB + p * QT * 128 + j * 2048, 512, 64),
                     qt > 0 || j > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  const int ka = k0 + ra, kb = ka + 8;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = col0 + jj * 8 + 2 * t4;
    if (ka < S)
      *reinterpret_cast<unsigned*>(out + (row0 + ka) * ld_g + col) =
          pack_bf16x2(acc[4 * jj], acc[4 * jj + 1]);
    if (kb < S)
      *reinterpret_cast<unsigned*>(out + (row0 + kb) * ld_g + col) =
          pack_bf16x2(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

// The dkv kernel at d = 192: one block per (element, head, 64-key tile),
// its two warpgroups on the two accumulators (dkv192_role).  The block's K
// and V tiles and each query's m, l, 1 / l and di are loaded once, the
// head's Q and dO a tile at a time into two buffers.
template <int NK, bool DROP>
__global__ void __launch_bounds__(256, 1)
    dkv192_wgmma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, int ld,
                        const bf16* __restrict__ dctx,
                        const float* __restrict__ mask,
                        const float* __restrict__ stats,
                        const float* __restrict__ di,
                        bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
                        int ld_g, int S, float sm_scale, DropParams drop) {
  constexpr int D = 192;
  using Sh = Bwd192<NK>;
  constexpr int NQ = Sh::NQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sO = sQ + 2 * Sh::QTB;  // dO
  unsigned char* sK = sO + 2 * Sh::QTB;
  unsigned char* sV = sK + Sh::QTB;
  unsigned char* sP = sV + Sh::QTB;  // drop(p), bf16
  unsigned char* sS = sP + QTILE;    // ds, bf16
  float* sPf = reinterpret_cast<float*>(sS + QTILE);  // p, f32
  float* sM = sPf + QT * QT;
  float* sSt = sM + NQ;  // m, l, 1 / l, di of each query
  unsigned* keep = reinterpret_cast<unsigned*>(sSt + 4 * NQ);

  const int head = blockIdx.y, elem = blockIdx.z;
  const int n_heads = gridDim.y, H = n_heads * D, k0 = blockIdx.x * QT;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;
  const size_t bhs = (size_t)gridDim.z * n_heads * S;
  const size_t off = row0 * ld + head * D;
  const int nq = (S + QT - 1) / QT * QT;
  const bf16* o_src = dctx + row0 * H + head * D;

  copy_rows<D>(sQ, q + off, ld, 0, QT, S, threadIdx.x, 256);
  copy_rows<D>(sO, o_src, H, 0, QT, S, threadIdx.x, 256);
  copy_rows<D>(sK, k + off, ld, k0, QT, S, threadIdx.x, 256);
  copy_rows<D>(sV, v + off, ld, k0, QT, S, threadIdx.x, 256);
  cp_async_commit();
  // rows past S: m = 0, l = 1, di = 0 (their p is 0, their dO rows 0)
  for (int j = threadIdx.x; j < nq; j += 256) {
    const bool ok = j < S;
    const float l = ok ? stats[bhs + prow0 + j] : 1.f;
    sM[j] = ok ? mask[row0 + j] : __int_as_float(0x7fc00000);
    sSt[j] = ok ? stats[prow0 + j] : 0.f;
    sSt[nq + j] = l;
    sSt[2 * nq + j] = __frcp_rn(l);
    sSt[3 * nq + j] = ok ? di[prow0 + j] : 0.f;
  }
  for (int j = nq + threadIdx.x; j < NQ; j += 256)  // keys of the last tile
    sM[j] = __int_as_float(0x7fc00000);
  // keep bits of every query against this block's 64 keys: row q, word w
  // = keys k0 + 32 w ..
  if (DROP) build_keep(keep, S, 2, 2, drop, prow0, k0, threadIdx.x, 256);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

#define NBK_DKV192_ROLE(WG, W, OUT)                                         \
  dkv192_role<WG, W, DROP>(q + off, ld, o_src, H, sQ, sO, sK, sV, sP, sS,   \
                           sPf, sM, sSt, nq, keep, k0, S, sm_scale, drop,   \
                           OUT, row0, ld_g, head * D)
  const bool tail = NK % 64 != 0 && k0 + QT > NK;
  if (threadIdx.x < 128) {
    if (tail)
      NBK_DKV192_ROLE(0, 32, dv_out);
    else
      NBK_DKV192_ROLE(0, 64, dv_out);
  } else {
    if (tail)
      NBK_DKV192_ROLE(1, 32, dk_out);
    else
      NBK_DKV192_ROLE(1, 64, dk_out);
  }
#undef NBK_DKV192_ROLE
}

// -------------------------------------------------------------------- //
// 5. The wgmma pair at d = 192, 256 < S <= 512: K and V streamed
// -------------------------------------------------------------------- //

// The dq kernel's shared memory past 256 keys: 1024-byte alignment slack,
// the tile's Q and dO, a ring of two 64-key K tiles and a V tile a
// warpgroup (each 64 rows of three 128-byte-swizzled panels, 24 KB; at
// the tile's end each warpgroup's first K slot carries the dq sums it
// hands the other), the key segment ids, the tile's keep table, the di
// halves: 199.75 KB, one block an SM.  The dkv kernel is section 4's at
// NK = 512 (191 KB: its per-query arrays sized for 512 queries, its
// loops over the run's own S).
constexpr int LONG192_DQ_SMEM = 1024 + 8 * Long192::TB + Long192::MAXK * 4 +
                                QT * Long192::KSTRIDE * 4 + 2 * QT * 4;

// The dq kernel at d = 192 past 256 keys: one block per (element, head)
// and a run of its 64-query tiles, two warpgroups that split each tile's
// 64-key chunks (warpgroup w takes chunks w, w + 2, ...: whole chunks from
// a multiple of 64, so S and dP are the forward's products bit for bit)
// and stream their K and V tiles through their own slots.  di must be
// complete before ds, so each warpgroup sweeps its chunks twice: sweep 1
// issues S = Q K^T and dP = dO V^T, rebuilds p from the saved statistics,
// drops dP and sums dp p (the chunk's keep bits drawn while its products
// run); the halves of di meet in sDi; sweep 2 issues S and dP again and
// packs ds = bf16(p (dp - di) sm_scale) in registers as the A operand of
// dq += ds K (three m64n64k16 a k16 step, the K tile read MN-major).  Each
// warpgroup holds a whole 64 x 192 f32 partial dq (96 registers a thread
// beside a chunk's 32 scores and 32 dP); the partials meet at the tile's
// end, each warpgroup summing and storing 96 of the 192 columns (a + b:
// the same bits either way round).  A step copies its next K tile while
// its products run and its next V tile once dP is done; both warpgroups
// run one code path, their chunks an offset.
template <bool DROP>
__global__ void __launch_bounds__(256, 1)
    dq192_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, int ld,
                      const bf16* __restrict__ dctx,
                      const float* __restrict__ mask,
                      const float* __restrict__ stats, float* __restrict__ di,
                      bf16* __restrict__ dq, int ld_g, int S, int tpb,
                      float sm_scale, DropParams drop) {
  constexpr int D = 192;
  using Sh = Long192;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sO = sQ + Sh::TB;  // dO
  float* sM = reinterpret_cast<float*>(sO + 7 * Sh::TB);
  unsigned* keep = reinterpret_cast<unsigned*>(sM + Sh::MAXK);
  float* sDi = reinterpret_cast<float*>(keep + QT * Sh::KSTRIDE);

  const int head = blockIdx.y, elem = blockIdx.z, n_heads = gridDim.y;
  const int H = n_heads * D;
  const int t0 = blockIdx.x * tpb;
  const int t_end = min((S + QT - 1) / QT, t0 + tpb);
  const int n_kt = (S + QT - 1) / QT;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;  // Philox row of query 0
  const size_t bhs = (size_t)gridDim.z * n_heads * S;
  const size_t off = row0 * ld + head * D;
  const bf16* k_src = k + off;
  const bf16* v_src = v + off;
  const bf16* o_src = dctx + row0 * H + head * D;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = (tid >> 5) * 16 + g;
  const float nan = __int_as_float(0x7fc00000);
  // this warpgroup's K ring (two slots) and V slot; its chunks
  unsigned char* sKw = sO + Sh::TB + wg * 3 * Sh::TB;
  unsigned char* sVw = sKw + 2 * Sh::TB;
  const int m = (n_kt - wg + 1) / 2;  // S > 256: at least two each
  float* sRed = reinterpret_cast<float*>(sKw);

  for (int j = threadIdx.x; j < n_kt * QT; j += 256)
    sM[j] = j < S ? mask[row0 + j] : nan;
  float sc[QT / 2], dp[QT / 2], acc[D / 2];
  for (int t = t0; t < t_end; ++t) {
    const int q0 = t * QT, qa = q0 + ra, qb = qa + 8;
    copy_rows<D>(sQ, q + off, ld, q0, QT, S, threadIdx.x, 256);
    copy_rows<D>(sO, o_src, H, q0, QT, S, threadIdx.x, 256);
    copy_rows<D>(sKw, k_src, ld, wg * QT, QT, S, tid, 128);
    copy_rows<D>(sVw, v_src, ld, wg * QT, QT, S, tid, 128);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    // a query row past S matches no key, and m = 0 makes its p 0
    const float qma = qa < S ? sM[qa] : nan, qmb = qb < S ? sM[qb] : nan;
    const float ma = qa < S ? stats[prow0 + qa] : 0.f;
    const float mb = qb < S ? stats[prow0 + qb] : 0.f;
    const float la = qa < S ? stats[bhs + prow0 + qa] : 1.f;
    const float lb = qb < S ? stats[bhs + prow0 + qb] : 1.f;
    const float rla = __frcp_rn(la), rlb = __frcp_rn(lb);
    float da = 0.f, db = 0.f;
    for (int u = 0; u < 2 * m; ++u) {
      const bool second = u >= m;
      const int i = second ? u - m : u, c = wg + 2 * i;
      const unsigned char* sKc = fresh(sKw) + (u & 1) * Sh::TB;
      if (u > 0) {  // this step's K and V have landed
        cp_async_wait<0>();
        fence_proxy_async();
        warpgroup_sync(wg);
      }
      issue_scores<QT, D>(sc, fresh(sQ), sKc, nullptr, QT * 128);
      issue_scores<QT, D>(dp, fresh(sO), fresh(sVw), nullptr, QT * 128);
      if (u + 1 < 2 * m) {  // the next step's K, into the other slot
        const int cn = wg + 2 * (u + 1 < m ? u + 1 : u + 1 - m);
        copy_rows<D>(sKw + ((u + 1) & 1) * Sh::TB, k_src, ld, cn * QT, QT, S,
                     tid, 128);
      }
      cp_async_commit();
      if (DROP && !second)  // the chunk's keep bits while the products run
        build_keep(keep + 2 * c, QT, 2, Sh::KSTRIDE, drop, prow0 + q0, c * QT,
                   tid, 128);
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      warpgroup_sync(wg);  // every warp's dP has read the V slot
      if (u + 1 < 2 * m) {
        const int cn = wg + 2 * (u + 1 < m ? u + 1 : u + 1 - m);
        copy_rows<D>(sVw, v_src, ld, cn * QT, QT, S, tid, 128);
      }
      cp_async_commit();
      float xa = -INFINITY, xb = -INFINITY;  // row maxima: the saved ones
      mask_scores<QT>(sc, sM + c * QT, qma, qmb, sm_scale, t4, xa, xb);
      rebuild_probs<QT / 2>(sc, ma, mb, la, lb, rla, rlb);
      drop_frag<QT, DROP>(dp, keep, Sh::KSTRIDE, ra, c * QT, t4,
                          drop.inv_keep);
      if (!second) {
#pragma unroll
        for (int e = 0; e < QT / 2; ++e) {
          if (e & 2)
            db = fmaf(dp[e], sc[e], db);
          else
            da = fmaf(dp[e], sc[e], da);
        }
        if (i + 1 == m) {  // di's halves meet: half 0 + half 1 in both
          da = quad_sum(da);
          db = quad_sum(db);
          if (t4 == 0) {
            sDi[wg * QT + ra] = da;
            sDi[wg * QT + ra + 8] = db;
          }
          pair_sync();
          da = sDi[ra] + sDi[QT + ra];
          db = sDi[ra + 8] + sDi[QT + ra + 8];
          if (wg == 0 && t4 == 0) {
            if (qa < S) di[prow0 + qa] = da;
            if (qb < S) di[prow0 + qb] = db;
          }
        }
      } else {
        unsigned dsa[QT / 4];
#pragma unroll
        for (int e = 0; e < QT / 2; e += 2) {
          const float dd = (e & 2) ? db : da;
          dsa[e / 2] = pack_bf16x2(
              __fmul_rn(__fmul_rn(sc[e], __fsub_rn(dp[e], dd)), sm_scale),
              __fmul_rn(__fmul_rn(sc[e + 1], __fsub_rn(dp[e + 1], dd)),
                        sm_scale));
        }
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < QT / 16; ++j)  // 16 keys of K: 2048 bytes
            wgmma_rs_n64(acc + 32 * p, dsa + 4 * j,
                         smem_desc(sKc + p * QT * 128 + j * 2048, 512, 64),
                         i > 0 || j > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
      }
    }
    // the partials meet: each warpgroup hands the other the dq sums of the
    // columns it does not store (the first stores columns 0-95, the second
    // 96-191) in its first K slot, and adds the other's to its own
    constexpr int HALF = D / 4;  // 48 sums a thread
    const float* theirs = reinterpret_cast<const float*>(
        sO + Sh::TB + (1 - wg) * 3 * Sh::TB);
#pragma unroll
    for (int j = 0; j < HALF; ++j)
      sRed[j * 128 + tid] = wg ? acc[j] : acc[HALF + j];
    pair_sync();
    float mine[HALF];
#pragma unroll
    for (int j = 0; j < HALF; ++j)
      mine[j] = (wg ? acc[HALF + j] : acc[j]) + theirs[j * 128 + tid];
#pragma unroll
    for (int jj = 0; jj < HALF / 4; ++jj) {
      const int col = head * D + wg * (D / 2) + jj * 8 + 2 * t4;
      if (qa < S)
        *reinterpret_cast<unsigned*>(dq + (row0 + qa) * ld_g + col) =
            pack_bf16x2(mine[4 * jj], mine[4 * jj + 1]);
      if (qb < S)
        *reinterpret_cast<unsigned*>(dq + (row0 + qb) * ld_g + col) =
            pack_bf16x2(mine[4 * jj + 2], mine[4 * jj + 3]);
    }
    __syncthreads();  // the sums are read: every slot is free
  }
}

long long wgmma_launches[3] = {0, 0, 0};  // the wgmma pairs at d = 64, 96, 192

// Makes dynamic shared memory of smem bytes available to a two-warpgroup
// dq kernel and reads how many of its blocks an SM runs into per_sm.
template <typename Kernel>
cudaError_t prepare_dq2(Kernel kernel, int smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, 256,
                                                      smem);
  return e == cudaSuccess && *per_sm == 0 ? cudaErrorInvalidConfiguration
                                          : e;
}

template <int NK, int D, bool DROP>
int launch_wgmma(const Operands& a, cudaStream_t stream) {
  using Sh = BwdShape<NK, D>;
  // the dq kernel: one warpgroup a query tile at d = 64 and S <= 256; two
  // warpgroups a block and a run of query tiles at d = 96
  // (dq96_wgmma_kernel) and at d = 64 past 256 keys (dq64x2_wgmma_kernel)
  constexpr bool ONE = D == 64 && NK <= 256;
  static int dq_per_sm = 0;  // dq blocks an SM runs (two warpgroups)
  static bool ready = false;
  if (!ready) {
    cudaError_t e;
    if constexpr (ONE)
      e = cudaFuncSetAttribute(dq_wgmma_kernel<NK, DROP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Sh::DQ_SMEM);
    else if constexpr (D == 64)
      e = prepare_dq2(dq64x2_wgmma_kernel<NK, DROP>, Sh::DQ64X2_SMEM,
                      &dq_per_sm);
    else
      e = prepare_dq2(dq96_wgmma_kernel<NK, DROP>, Sh::DQ2_SMEM, &dq_per_sm);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dkv_wgmma_kernel<NK, D, DROP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Sh::DKV_SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int n_qt = (a.S + QT - 1) / QT;
  dim3 grid(n_qt, a.n_heads, a.B);
  if constexpr (ONE) {
    dq_wgmma_kernel<NK, DROP><<<grid, 128, Sh::DQ_SMEM, stream>>>(
        a.q, a.k, a.v, a.ld, a.dctx, a.mask, a.stats, a.di, a.dq, a.ld_g,
        a.S, a.sm_scale, a.drop);
  } else {
    // a tile runs on both warpgroups, each over half the keys
    const int tpb = tiles_per_block(n_qt, a.B * a.n_heads,
                                    dq_per_sm * sm_count(), 2);
    dim3 dq_grid((n_qt + tpb - 1) / tpb, a.n_heads, a.B);
    if constexpr (D == 64)
      dq64x2_wgmma_kernel<NK, DROP><<<dq_grid, 256, Sh::DQ64X2_SMEM,
                                      stream>>>(
          a.q, a.k, a.v, a.ld, a.dctx, a.mask, a.stats, a.di, a.dq, a.ld_g,
          a.S, tpb, a.sm_scale, a.drop);
    else
      dq96_wgmma_kernel<NK, DROP><<<dq_grid, 256, Sh::DQ2_SMEM, stream>>>(
          a.q, a.k, a.v, a.ld, a.dctx, a.mask, a.stats, a.di, a.dq, a.ld_g,
          a.S, tpb, a.sm_scale, a.drop);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkv_wgmma_kernel<NK, D, DROP><<<grid, 128, Sh::DKV_SMEM, stream>>>(
      a.q, a.k, a.v, a.ld, a.dctx, a.mask, a.stats, a.di, a.dk, a.dv, a.ld_g,
      a.S, a.sm_scale, a.drop);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++wgmma_launches[D == 96];
  return (int)e;
}

template <int NK, bool DROP>
int launch_wgmma192(const Operands& a, cudaStream_t stream) {
  using Sh = Bwd192<NK>;
  static int dq_per_sm = 0;  // dq blocks an SM runs
  if (dq_per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        dq192_wgmma_kernel<NK, DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::DQ_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dkv192_wgmma_kernel<NK, DROP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Sh::DKV_SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &dq_per_sm, dq192_wgmma_kernel<NK, DROP>, 256, Sh::DQ_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dq_per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int n_qt = (a.S + QT - 1) / QT;
  // a dq block's tiles run one after another, each on both warpgroups
  const int tpb = tiles_per_block(n_qt, a.B * a.n_heads,
                                  dq_per_sm * sm_count(), 1);
  dim3 dq_grid((n_qt + tpb - 1) / tpb, a.n_heads, a.B);
  dq192_wgmma_kernel<NK, DROP><<<dq_grid, 256, Sh::DQ_SMEM, stream>>>(
      a.q, a.k, a.v, a.ld, a.dctx, a.mask, a.stats, a.di, a.dq, a.ld_g, a.S,
      tpb, a.sm_scale, a.drop);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_qt, a.n_heads, a.B);
  dkv192_wgmma_kernel<NK, DROP><<<grid, 256, Sh::DKV_SMEM, stream>>>(
      a.q, a.k, a.v, a.ld, a.dctx, a.mask, a.stats, a.di, a.dk, a.dv, a.ld_g,
      a.S, a.sm_scale, a.drop);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++wgmma_launches[2];
  return (int)e;
}

// Past 256 keys at d = 192: the streaming dq kernel, then section 4's dkv
// kernel at NK = 512.
template <bool DROP>
int launch_long192(const Operands& a, cudaStream_t stream) {
  using Sh = Bwd192<Long192::MAXK>;
  static int dq_per_sm = 0;  // dq blocks an SM runs
  if (dq_per_sm == 0) {
    cudaError_t e = prepare_dq2(dq192_long_kernel<DROP>, LONG192_DQ_SMEM,
                                &dq_per_sm);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dkv192_wgmma_kernel<Long192::MAXK, DROP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Sh::DKV_SMEM);
    if (e != cudaSuccess) {
      dq_per_sm = 0;
      return (int)e;
    }
  }
  const int n_qt = (a.S + QT - 1) / QT;
  // a dq block's tiles run one after another, each on both warpgroups
  const int tpb = tiles_per_block(n_qt, a.B * a.n_heads,
                                  dq_per_sm * sm_count(), 1);
  dim3 dq_grid((n_qt + tpb - 1) / tpb, a.n_heads, a.B);
  dq192_long_kernel<DROP><<<dq_grid, 256, LONG192_DQ_SMEM, stream>>>(
      a.q, a.k, a.v, a.ld, a.dctx, a.mask, a.stats, a.di, a.dq, a.ld_g, a.S,
      tpb, a.sm_scale, a.drop);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_qt, a.n_heads, a.B);
  dkv192_wgmma_kernel<Long192::MAXK, DROP><<<grid, 256, Sh::DKV_SMEM,
                                             stream>>>(
      a.q, a.k, a.v, a.ld, a.dctx, a.mask, a.stats, a.di, a.dk, a.dv, a.ld_g,
      a.S, a.sm_scale, a.drop);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++wgmma_launches[2];
  return (int)e;
}

// the window: S rounded up to 32 (64 at least; 224 to 256), as the
// forward's; past 256 keys (d = 64) S rounded up to 128, so that each dq
// warpgroup takes whole 64-key chunks (the forward's two 256-key windows:
// any whole chunks give its scores)
template <int D, bool DROP>
int launch_wgmma_s(const Operands& a, cudaStream_t stream) {
  if (a.S <= 64) return launch_wgmma<64, D, DROP>(a, stream);
  if (a.S <= 96) return launch_wgmma<96, D, DROP>(a, stream);
  if (a.S <= 128) return launch_wgmma<128, D, DROP>(a, stream);
  if (a.S <= 160) return launch_wgmma<160, D, DROP>(a, stream);
  if (a.S <= 192) return launch_wgmma<192, D, DROP>(a, stream);
  if (a.S <= 256) return launch_wgmma<256, D, DROP>(a, stream);
  if constexpr (D == WD) {
    if (a.S <= 384) return launch_wgmma<384, D, DROP>(a, stream);
    if (a.S <= 512) return launch_wgmma<512, D, DROP>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool DROP>
int launch_wgmma192_s(const Operands& a, cudaStream_t stream) {
  if (a.S <= 64) return launch_wgmma192<64, DROP>(a, stream);
  if (a.S <= 96) return launch_wgmma192<96, DROP>(a, stream);
  if (a.S <= 128) return launch_wgmma192<128, DROP>(a, stream);
  if (a.S <= 160) return launch_wgmma192<160, DROP>(a, stream);
  if (a.S <= 192) return launch_wgmma192<192, DROP>(a, stream);
  if (a.S <= 256) return launch_wgmma192<256, DROP>(a, stream);
  if (a.S <= Long192::MAXK) return launch_long192<DROP>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v as nbk_seg_attention reads them (row stride ld), dctx (B*S,
// n_heads * d) bf16, mask (B, S) f32, stats (2, B, n_heads, S) f32 from
// nbk_seg_attention -> dq, dk, dv bf16 with row stride ld_g (16-byte
// aligned, ld_g even: the q | k | v column blocks of one (B*S, 3h)
// buffer, or (B, S, n_heads, d) tensors); di (B, n_heads, S) f32 is
// scratch (rowsum(dp * p)).  d <= 256 with d % 8 == 0, S <= 512, on
// the instance the caller names: 0, the wgmma pair (d = 64 or 192; d =
// 96, S <= 256), or the width of a mma.sync pair (32, 64, 96, 128, 192
// or 256, at least d); any other instance, d or S is refused.  The prob
// dropout as in the forward.
int nbk_seg_attention_bwd(const void* q, const void* k, const void* v,
                          int ld, const void* dctx, const float* mask,
                          const float* stats, float* di, void* dq, void* dk,
                          void* dv, int ld_g, int B, int S, int n_heads,
                          int d, int instance, float sm_scale,
                          unsigned long long seed, int stream,
                          unsigned thresh, float inv_keep, int drop_on,
                          void* cuda_stream) {
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
  a.dh = d;
  a.sm_scale = sm_scale;
  a.drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  if (S <= 0 || d <= 0 || d % 8) return (int)cudaErrorInvalidValue;
  if (instance == 0) {  // S > 256 at d = 96 is refused below
    if (d == WD)
      return a.drop.on ? launch_wgmma_s<64, true>(a, s)
                       : launch_wgmma_s<64, false>(a, s);
    if (d == 96)
      return a.drop.on ? launch_wgmma_s<96, true>(a, s)
                       : launch_wgmma_s<96, false>(a, s);
    if (d == 192)
      return a.drop.on ? launch_wgmma192_s<true>(a, s)
                       : launch_wgmma192_s<false>(a, s);
    return (int)cudaErrorInvalidValue;
  }
  if (d > instance) return (int)cudaErrorInvalidValue;
  switch (instance) {
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 96: return launch<96>(a, s);
    case 128: return launch<128>(a, s);
    case 192: return launch<192>(a, s);
    case 256: return launch<256>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches of the wgmma pairs since the library was loaded, at head dim d
// (64, 96 or 192; 0: all three; -1 for any other d): which instance ran.
long long nbk_seg_attention_bwd_wgmma_launches(int d) {
  return d == 64    ? wgmma_launches[0]
         : d == 96  ? wgmma_launches[1]
         : d == 192 ? wgmma_launches[2]
         : d == 0   ? wgmma_launches[0] + wgmma_launches[1] + wgmma_launches[2]
                    : -1;
}

}  // extern "C"
