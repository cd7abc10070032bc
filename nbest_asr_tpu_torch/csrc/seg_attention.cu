// Segment-masked softmax attention per (element, head): q, k and v are
// read by row stride and column offset -- the three column blocks of the
// (n, 3h) QKV buffer, or standalone (b, s, heads, d) tensors -- and ctx is
// written (n, h), with no head transposes.  Training adds the Philox prob
// dropout and each row's softmax statistics.
//
// Replaces the head loop of the TPU attention-block megakernel:
//   nbest_asr_tpu/ops/fused_attention.py:_fab_fwd_kernel (:167-180),
//   through `_head_probs` (:103-126), with its prob dropout (:175-178);
// the int8 serving megakernel's head loop
//   nbest_asr_tpu/ops/int8_serving.py:_attn_i8_kernel (:169-189);
// and the single-block flash forward
//   nbest_asr_tpu/ops/flash_attention.py:_sb_fwd_kernel (:364),
// which computes the same function (`_sb_probs` :350 is `_head_probs`
// with a caller's sm_scale), so it maps onto this kernel instead of a
// second copy of it.
// Contract kept: SEGMENT-mask semantics (a query attends exactly the keys
// carrying its own mask value; pads attend pads), masked scores filled
// with MASK_VALUE (-0.7 * FLT_MAX), a PLAIN softmax in f32 over the whole
// row (p = exp(s - max) / sum with the row's exact max, seq <= 512), then
// p = keep ? p * f32(1 / (1 - rate)) : 0 in f32, probs rounded to bf16
// before P.V, f32 accumulation, ctx rounded to bf16.  Keys past the
// sequence end are excluded outright (their probs are 0), which is what
// the TPU wrappers' -1 mask padding achieves (fused_attention.py:791-797,
// flash_attention.py:634-639), so nothing is padded.  The keep bits are
// Philox stream 3 at row (elem * n_heads + head) * S + q, column k
// (attention.cuh), so the backward kernels -- and the tiled flash
// kernels, at any tiling -- regenerate them.
//
// Three kernels; the caller names the instance (ops/kernels.py,
// attn_instance: the one rule) and nbk_seg_attention runs it or refuses:
//   d = 64, S <= 512            the wgmma kernel (every BERT-base, -large,
//                               RoBERTa and XLM-R head)
//   d = 96, S <= 256            the wgmma kernel (the quality tools' 8
//                               heads of 96, every DSTC2 bucket)
//   d = 192, S <= 256           the d = 192 wgmma kernel (the CLI's
//                               from-scratch 4 heads of 192, every DSTC2
//                               bucket)
//   d = 192, 256 < S <= 512     the d = 192 streaming wgmma kernel (that
//                               default on packed 512-token rows, long
//                               buckets and N-best rows)
//   every other d <= 256 with   the mma.sync kernel, on its instance of
//   d % 8 == 0                  width 32, 64, 96, 128, 192 or 256 (flash's
//                               d = 32 single-block route, d = 96 past
//                               256, the wide heads); a d between
//                               two widths runs on the wider, its columns
//                               past d zero-filled on load and never
//                               stored (attention.cuh, instance_width):
//                               d = 40 .. 56 on the 64-wide instance, d =
//                               72 .. 88 on the 96-wide one and d = 136 ..
//                               184 on the 192-wide one
// and refuses every other shape, and an instance that cannot run the
// shape (cudaErrorInvalidValue).  Shared memory bounds the wgmma rows: a
// block keeps its head's K and V, which at S = 512 take 128 KB at d = 64
// but 192 KB at d = 96 and 384 KB at d = 192 (and at S = 256 already 192
// KB at d = 192, beside which one Q tile fits, not two a warpgroup), so
// past 256 keys the d = 192 kernel streams them instead; d = 128 stays on
// the mma.sync kernel (no DSTC2 configuration runs it).
//
// The d = 192 wgmma kernel is the same per tile, on three 128-byte-
// swizzled panels (columns 0-63, 64-127, 128-191: 12 k16 steps a score,
// 3 m64n64k16 P.V products a k16 step), with K and V resident (192 KB at
// S = 256) and one Q buffer that the block's two warpgroups take turns on
// (seg_attn192_wgmma_kernel): one block of eight warps an SM, whose
// softmax instructions' latency, not their count, sets its pace.  Past
// 256 keys (seg_attn192_long_kernel) a block is one warpgroup that keeps
// only its Q tile and streams K and V a 64-key tile at a time through a
// two-slot K ring and a V slot, sweeping the keys twice (the row max and
// sum, then the probs and P.V), two blocks an SM.
//
// The wgmma kernel.  A block owns one (element, head) and a run of its
// 64-query tiles; it copies that head's whole K and V (S <= 512 keys at d
// = 64, <= 128 KB; S <= 256 at d = 96, <= 96 KB) into swizzled shared
// memory once (cp.async, rows past S zero-filled), and its consumer
// warpgroups (one; two at S > 256 or d = 96, each with its own query
// tiles) share them.  A 96-column row is a 128-byte-swizzled panel of
// columns 0-63 and a 64-byte-swizzled panel of columns 64-95
// (attention.cuh: the smaller of the two layouts that wgmma reads, which
// leaves room for the second warpgroup).  Per tile, one warpgroup runs S
// = Q K^T as wgmma m64n64k16 (and one m64n32k16 for a key count that is
// an odd multiple of 32) from shared memory, 4 k16 steps on panel 0 and 2
// on panel 1 at d = 96, so each thread holds its two rows' scores for up
// to 256 keys in registers: the exact row max and sum come from registers
// in one sweep (one expf and one division a prob), and the probs are
// normalised, dropped, rounded to bf16 and fed to P.V (wgmma m64n64k16,
// and m64n32k16 for panel 1, A from registers, V the MN-major B in shared
// memory) without passing through memory.  At 256 < S <= 512 (d = 64) a
// row does not fit one accumulator: the scores of keys 0-255 give a max
// and sum, those of keys 256-511 are kept, the sums combine
// (l0 exp(m0 - m) + the kept keys' exps), and keys 0-255's scores are
// recomputed for their probs (1.5 score products instead of 1; staging
// the scores in shared memory instead would take 128 KB a warpgroup beside
// 128 KB of K and V, more than an SM has).  The keep
// bits of the tile's 64 rows are drawn into shared memory while the score
// product runs; the next tile's Q is copied while this one computes, and
// the other blocks resident on the SM overlap a block's K / V copy.  The
// launch picks the tiles a block takes from the occupancy: fewer K / V
// reloads against a fuller last wave.
//
// The mma.sync kernel.  The TPU kernel holds the whole (s, s) score matrix
// in VMEM.  Here a warp owns 16 query rows and the row statistics live in
// registers: pass 1 sweeps the key tiles for the row max and sum (the sum
// rescaled as the max grows), pass 2 recomputes the same scores bit for
// bit, normalises them exactly, drops them, rounds to bf16 and feeds them
// from registers straight into the P.V tensor-core MMA (the C fragment of
// S is the A fragment of P).  The max and sum it writes (8 bytes a row)
// let the backward rebuild p without pass 1.
//
// What bounds both on the H100: per head a few MFLOP on 2*s*d*2 bytes of
// K and V, so neither HBM (the bound is bytes: q, k, v read once, ctx
// written once) nor the tensor cores' rate does.  The wgmma kernel's time
// is its softmax's instructions -- mask, max, expf, sum, division and
// dropout, some 25 a score -- issued by one to four warpgroups an SM (the
// registers hold NK / 2 scores a thread); the mma.sync kernel's is the
// latency of its serial tile loop and second pass.  The keep bits add one
// 10-round Philox call per four probs, drawn once per tile.
#include "attention.cuh"

namespace {

using namespace nbk;
using namespace nbk::attn;

// ---------------------------------------------------------------------- //
// The wgmma kernel: d = 64, S <= 512; d = 96, S <= 256
// ---------------------------------------------------------------------- //

// A block's shape for NK-key score windows (NK a multiple of 32, <= 256;
// NWIN = 2 windows of 256 keys cover 256 < S <= 512 at d = 64) at head
// dim D (64 or 96).
template <int NK, int NWIN, int D>
struct Shape {
  static constexpr int KEYS = NK * NWIN;  // rows of sK and sV
  // consumer warpgroups: one a window at d = 64; two at d = 96, whose K
  // and V (96 KB at S = 256) leave room for one block an SM
  static constexpr int NWG = D == 96 ? 2 : NWIN;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int WORDS = KEYS / 32;  // keep-table words of a row
  static constexpr int KSTRIDE = WORDS | 1;  // odd: rows in other banks
  static constexpr int ROWB = D * 2;        // bytes of a row, both panels
  static constexpr int QTB = QT * ROWB;     // bytes of a Q tile
  // 1024-byte alignment slack, K, V, two Q tiles a warpgroup, the key
  // segment ids, a keep table a warpgroup
  static constexpr int SMEM = 1024 + 2 * KEYS * ROWB + NWG * 2 * QTB +
                              KEYS * 4 + NWG * QT * KSTRIDE * 4;
  // blocks an SM runs: registers (sc NK / 2, o D / 2 a thread) and the
  // shared memory above
  static constexpr int MIN_BLOCKS =
      NWG == 2 ? 1 : NK <= 96 ? 4 : NK <= 192 ? 3 : 2;
};

// sc = exp(sc - m) a row; la, lb += this thread's part of each row's sum.
template <int NK>
__device__ __forceinline__ void exp_scores(float (&sc)[NK / 2], float ma,
                                           float mb, float& la, float& lb) {
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) {
    sc[i] = expf(sc[i] - ((i & 2) ? mb : ma));
    if (i & 2)
      lb += sc[i];
    else
      la += sc[i];
  }
}

// p = e / l, dropped (keep: the tile's table, ra this thread's first row,
// word0 the window's first word), rounded to bf16 in registers -- the A
// fragments of the NK / 16 k-steps -- times the window's V (sVw, and sVw1
// its panel 1 at D = 96): issues and commits o (+)= P V, o's columns 0-63
// as m64n64k16, 64-95 as m64n32k16; at D = 192 columns 64-127 and 128-191
// as m64n64k16 on the panels NK * 128 bytes on.
template <int NK, int D, bool DROP>
__device__ __forceinline__ void probs_times_v(
    const float (&sc)[NK / 2], float (&o)[D / 2], const unsigned char* sVw,
    const unsigned char* sVw1, float la, float lb, const unsigned* keep,
    int kstride, int ra, int word0, const DropParams& drop, int t4,
    bool accumulate) {
  const float rla = __frcp_rn(la), rlb = __frcp_rn(lb);
  unsigned pa[NK / 4];
#pragma unroll
  for (int j = 0; j < NK / 16; ++j) {
    unsigned ka = 0, kb = 0;
    if (DROP) {  // keys 16 j .. 16 j + 15 lie in word j / 2
      ka = keep[ra * kstride + word0 + j / 2];
      kb = keep[(ra + 8) * kstride + word0 + j / 2];
    }
    float pf[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float pv = (e & 2) ? div_row(sc[8 * j + e], lb, rlb)
                         : div_row(sc[8 * j + e], la, rla);
      if (DROP) {
        const int bit = 16 * (j & 1) + 8 * (e >> 2) + 2 * t4 + (e & 1);
        pv = ((((e & 2) ? kb : ka) >> bit) & 1u) ? __fmul_rn(pv,
                                                             drop.inv_keep)
                                                 : 0.f;
      }
      pf[e] = pv;
    }
    pa[4 * j] = pack_bf16x2(pf[0], pf[1]);      // row g, keys 2t ..
    pa[4 * j + 1] = pack_bf16x2(pf[2], pf[3]);  // row g + 8
    pa[4 * j + 2] = pack_bf16x2(pf[4], pf[5]);  // row g, keys 8 + 2t ..
    pa[4 * j + 3] = pack_bf16x2(pf[6], pf[7]);  // row g + 8
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NK / 16; ++j)  // 16 keys of V: 2048 bytes a step
    wgmma_rs_n64(o, pa + 4 * j, smem_desc(sVw + j * 2048, 512, 64),
                 accumulate || j > 0);
  if constexpr (D == 96) {
#pragma unroll
    for (int j = 0; j < NK / 16; ++j)  // panel 1: 1024 bytes a step
      wgmma_rs_n32(o + 32, pa + 4 * j, smem_desc64(sVw1 + j * 1024, 1, 32),
                   accumulate || j > 0);
  }
  if constexpr (D == 192) {
#pragma unroll
    for (int p = 1; p < 3; ++p)
#pragma unroll
      for (int j = 0; j < NK / 16; ++j)
        wgmma_rs_n64(o + 32 * p, pa + 4 * j,
                     smem_desc(sVw + p * NK * 128 + j * 2048, 512, 64),
                     accumulate || j > 0);
  }
  wgmma_commit();
}

// One block: (element, head) = (blockIdx.z, blockIdx.y), query tiles
// blockIdx.x * tiles_per_block .. (+ tiles_per_block, at most ceil(S /
// 64)), warpgroup w taking every NWG-th from the w-th.
template <int NK, int NWIN, int D, bool DROP>
__global__ void __launch_bounds__(Shape<NK, NWIN, D>::THREADS,
                                  Shape<NK, NWIN, D>::MIN_BLOCKS)
    seg_attn_wgmma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, int ld,
                        const float* __restrict__ mask,
                        bf16* __restrict__ ctx, float* __restrict__ stats,
                        int S, int tiles_per_block, float sm_scale,
                        DropParams drop) {
  using Sh = Shape<NK, NWIN, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 128-byte swizzled tiles need 1024-byte aligned bases
  unsigned char* sK =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + Sh::KEYS * Sh::ROWB;
  unsigned char* sQ = sV + Sh::KEYS * Sh::ROWB;
  float* sM = reinterpret_cast<float*>(sQ + Sh::NWG * 2 * Sh::QTB);
  unsigned* sKeep = reinterpret_cast<unsigned*>(sM + Sh::KEYS);
  // panel 1 of K and V (d = 96)
  const unsigned char* sK1 = sK + Sh::KEYS * 128;
  const unsigned char* sV1 = sV + Sh::KEYS * 128;

  const int head = blockIdx.y, elem = blockIdx.z, n_heads = gridDim.y;
  const int t_end = min((S + QT - 1) / QT,
                        (int)(blockIdx.x + 1) * tiles_per_block);
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;  // Philox row of query 0
  const int H = n_heads * D;
  const size_t off = row0 * ld + head * D;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  unsigned char* myQ = sQ + wg * 2 * Sh::QTB;
  unsigned* keep = sKeep + wg * QT * Sh::KSTRIDE;
  int t = blockIdx.x * tiles_per_block + wg;

  // the head's K and V, the key segment ids (NaN past S: such a key
  // matches no query, so its score is MASK_VALUE and its prob 0) and each
  // warpgroup's first Q tile
  for (int j = threadIdx.x; j < Sh::KEYS; j += Sh::THREADS)
    sM[j] = j < S ? mask[row0 + j] : __int_as_float(0x7fc00000);
  copy_rows<D>(sK, k + off, ld, 0, Sh::KEYS, S, threadIdx.x, Sh::THREADS);
  copy_rows<D>(sV, v + off, ld, 0, Sh::KEYS, S, threadIdx.x, Sh::THREADS);
  if (t < t_end) copy_rows<D>(myQ, q + off, ld, t * QT, QT, S, tid, 128);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  const int lane = tid & 31, w4 = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int ra = w4 * 16 + g;  // this thread's first row of the tile
  const size_t bhs = (size_t)gridDim.z * n_heads * S;
  float sc[NK / 2], o[D / 2];
  for (int i = 0; t < t_end; ++i, t += Sh::NWG) {
    const unsigned char* sQt = myQ + (i & 1) * Sh::QTB;
    const int q0 = t * QT, qa = q0 + ra, qb = qa + 8;
    // a query row past S matches no key; its output is never stored
    const float qma = qa < S ? sM[qa] : __int_as_float(0x7fc00000);
    const float qmb = qb < S ? sM[qb] : __int_as_float(0x7fc00000);
    float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
    issue_scores<NK, D>(sc, sQt, sK, sK1);
    if (DROP)  // the tile's keep bits while the product runs
      build_keep(keep, QT, Sh::WORDS, Sh::KSTRIDE, drop, prow0 + q0, 0, tid,
                 128);
    if (t + Sh::NWG < t_end)  // the next tile's Q into the other buffer
      copy_rows<D>(myQ + ((i + 1) & 1) * Sh::QTB, q + off, ld,
                   (t + Sh::NWG) * QT, QT, S, tid, 128);
    cp_async_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    if (DROP) warpgroup_sync(wg);  // the keep table is complete
    mask_scores<NK>(sc, sM, qma, qmb, sm_scale, t4, ma, mb);
    ma = quad_max(ma);
    mb = quad_max(mb);
    if constexpr (NWIN == 2) {
      // keys 0-255 gave (ma, mb) and their sum; keys 256-511 are kept
      exp_scores<NK>(sc, ma, mb, la, lb);
      la = quad_sum(la);
      lb = quad_sum(lb);
      issue_scores<NK>(sc, sQt, sK + NK * 128);
      wgmma_wait<0>();
      fence_acc(sc);
      float na = -INFINITY, nb = -INFINITY;
      mask_scores<NK>(sc, sM + NK, qma, qmb, sm_scale, t4, na, nb);
      na = fmaxf(ma, quad_max(na));
      nb = fmaxf(mb, quad_max(nb));
      la *= expf(ma - na);
      lb *= expf(mb - nb);
      ma = na;
      mb = nb;
      float ea = 0.f, eb = 0.f;
      exp_scores<NK>(sc, ma, mb, ea, eb);
      la += quad_sum(ea);
      lb += quad_sum(eb);
      probs_times_v<NK, D, DROP>(sc, o, sV + NK * 128, nullptr, la, lb, keep,
                                 Sh::KSTRIDE, ra, NK / 32, drop, t4, false);
      wgmma_wait<0>();
      fence_acc(o);
      // keys 0-255 again, now with the row's max and sum
      issue_scores<NK>(sc, sQt, sK);
      wgmma_wait<0>();
      fence_acc(sc);
      float xa = -INFINITY, xb = -INFINITY, ya = 0.f, yb = 0.f;  // unused
      mask_scores<NK>(sc, sM, qma, qmb, sm_scale, t4, xa, xb);
      exp_scores<NK>(sc, ma, mb, ya, yb);
      probs_times_v<NK, D, DROP>(sc, o, sV, nullptr, la, lb, keep,
                                 Sh::KSTRIDE, ra, 0, drop, t4, true);
    } else {
      exp_scores<NK>(sc, ma, mb, la, lb);
      la = quad_sum(la);
      lb = quad_sum(lb);
      probs_times_v<NK, D, DROP>(sc, o, sV, sV1, la, lb, keep, Sh::KSTRIDE,
                                 ra, 0, drop, t4, false);
    }
    wgmma_wait<0>();
    fence_acc(o);
    if (stats != nullptr && t4 == 0) {
      if (qa < S) {
        stats[prow0 + qa] = ma;
        stats[bhs + prow0 + qa] = la;
      }
      if (qb < S) {
        stats[prow0 + qb] = mb;
        stats[bhs + prow0 + qb] = lb;
      }
    }
    // o[4 jj + e]: columns 8 jj + 2 t (+ 1), panel 0's m64n64 accumulator
    // then panel 1's m64n32
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int col = head * D + jj * 8 + 2 * t4;
      if (qa < S)
        *reinterpret_cast<unsigned*>(ctx + (row0 + qa) * H + col) =
            pack_bf16x2(o[4 * jj], o[4 * jj + 1]);
      if (qb < S)
        *reinterpret_cast<unsigned*>(ctx + (row0 + qb) * H + col) =
            pack_bf16x2(o[4 * jj + 2], o[4 * jj + 3]);
    }
    // the next Q tile has landed; this tile's Q buffer and keep table are
    // free
    cp_async_wait<0>();
    fence_proxy_async();
    warpgroup_sync(wg);
  }
}

long long wgmma_launches[3] = {0, 0, 0};  // at d = 64, 96, 192; host side

template <int NK, int NWIN, int D, bool DROP>
int launch_wgmma(const void* q, const void* k, const void* v, int ld,
                 const float* mask, void* ctx, float* stats, int B, int S,
                 int n_heads, float sm_scale, const DropParams& drop,
                 cudaStream_t stream) {
  using Sh = Shape<NK, NWIN, D>;
  static int per_sm = 0;  // blocks an SM runs
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        seg_attn_wgmma_kernel<NK, NWIN, D, DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, seg_attn_wgmma_kernel<NK, NWIN, D, DROP>, Sh::THREADS,
          Sh::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int n_qt = (S + QT - 1) / QT;
  const int tpb = tiles_per_block(n_qt, B * n_heads, per_sm * sm_count(),
                                  Sh::NWG);
  dim3 grid((n_qt + tpb - 1) / tpb, n_heads, B);
  seg_attn_wgmma_kernel<NK, NWIN, D, DROP><<<grid, Sh::THREADS, Sh::SMEM,
                                             stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), ld, mask, static_cast<bf16*>(ctx), stats,
      S, tpb, sm_scale, drop);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++wgmma_launches[D == 96];
  return (int)e;
}

// the window width: S rounded up to 32 (64 at least; 224 to 256), two
// windows of 256 past 256 (d = 64 only)
template <int D, bool DROP>
int launch_wgmma_s(const void* q, const void* k, const void* v, int ld,
                   const float* mask, void* ctx, float* stats, int B, int S,
                   int n_heads, float sm_scale, const DropParams& drop,
                   cudaStream_t st) {
#define NBK_WGMMA(NK, NWIN)                                                   \
  return launch_wgmma<NK, NWIN, D, DROP>(q, k, v, ld, mask, ctx, stats, B, S, \
                                         n_heads, sm_scale, drop, st)
  if (S <= 64) NBK_WGMMA(64, 1);
  if (S <= 96) NBK_WGMMA(96, 1);
  if (S <= 128) NBK_WGMMA(128, 1);
  if (S <= 160) NBK_WGMMA(160, 1);
  if (S <= 192) NBK_WGMMA(192, 1);
  if (S <= 256) NBK_WGMMA(256, 1);
  if constexpr (D == 64)
    if (S <= 512) NBK_WGMMA(256, 2);
#undef NBK_WGMMA
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------- //
// The wgmma kernel at d = 192, S <= 256
// ---------------------------------------------------------------------- //

// A d = 192 block's shape for NK-key windows (NK a multiple of 32, <= 256):
// 1024-byte alignment slack, K and V (three 128-byte-swizzled panels
// each), one Q tile the two warpgroups take turns on, the key segment ids,
// a keep table a warpgroup: 222.5 KB at NK = 256, one block an SM.
template <int NK>
struct Shape192 {
  static constexpr int ROWB = 192 * 2;   // bytes of a row, three panels
  static constexpr int QTB = QT * ROWB;  // bytes of a Q tile
  static constexpr int WORDS = NK / 32;
  static constexpr int KSTRIDE = WORDS | 1;
  static constexpr int SMEM =
      1024 + 2 * NK * ROWB + QTB + NK * 4 + 2 * QT * KSTRIDE * 4;
};

// The Q buffer's hand-over between the two warpgroups, which take the
// block's query tiles in turn: the warpgroup whose score product has read
// the buffer arrives at the other's barrier (named barrier 3 + the
// other's index), the other waits there before it fills the buffer.  One
// barrier a direction, so that a warpgroup's next arrival can never count
// toward a hand-over the other has not yet waited for.
__device__ __forceinline__ void q_free_arrive(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
}
__device__ __forceinline__ void q_free_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}

// One block: (element, head) = (blockIdx.z, blockIdx.y), query tiles t0 =
// blockIdx.x * tpb .. (+ tpb, at most ceil(S / 64)); warpgroup w takes
// tiles t0 + w, t0 + w + 2, ...  K and V of the head stay in shared
// memory; the tiles' Q pass through one buffer (K, V and two Q tiles a
// warpgroup, as at d = 96, would take 288 KB): a warpgroup copies its
// tile's Q once the other's score product is done with the previous one,
// so the two run half a tile apart, one's softmax beside the other's
// products.
template <int NK, bool DROP>
__global__ void __launch_bounds__(256, 1)
    seg_attn192_wgmma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v, int ld,
                             const float* __restrict__ mask,
                             bf16* __restrict__ ctx,
                             float* __restrict__ stats, int S, int tpb,
                             float sm_scale, DropParams drop) {
  constexpr int D = 192;
  using Sh = Shape192<NK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sV = sK + NK * Sh::ROWB;
  unsigned char* sQ = sV + NK * Sh::ROWB;
  float* sM = reinterpret_cast<float*>(sQ + Sh::QTB);
  unsigned* sKeep = reinterpret_cast<unsigned*>(sM + NK);

  const int head = blockIdx.y, elem = blockIdx.z, n_heads = gridDim.y;
  const int t0 = blockIdx.x * tpb;
  const int t_end = min((S + QT - 1) / QT, t0 + tpb);
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;  // Philox row of query 0
  const int H = n_heads * D;
  const size_t off = row0 * ld + head * D;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  unsigned* keep = sKeep + wg * QT * Sh::KSTRIDE;

  // the key segment ids (NaN past S: such a key matches no query), K, V
  // and the first tile's Q
  for (int j = threadIdx.x; j < NK; j += 256)
    sM[j] = j < S ? mask[row0 + j] : __int_as_float(0x7fc00000);
  copy_rows<D>(sK, k + off, ld, 0, NK, S, threadIdx.x, 256);
  copy_rows<D>(sV, v + off, ld, 0, NK, S, threadIdx.x, 256);
  copy_rows<D>(sQ, q + off, ld, t0 * QT, QT, S, threadIdx.x, 256);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  const int lane = tid & 31, w4 = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int ra = w4 * 16 + g;  // this thread's first row of the tile
  const size_t bhs = (size_t)gridDim.z * n_heads * S;
  float sc[NK / 2], o[D / 2];
  for (int t = t0 + wg; t < t_end; t += 2) {
    if (t > t0) {  // the other warpgroup's product has read tile t - 1
      q_free_wait(wg);
      copy_rows<D>(sQ, q + off, ld, t * QT, QT, S, tid, 128);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      warpgroup_sync(wg);
    }
    const int q0 = t * QT, qa = q0 + ra, qb = qa + 8;
    // a query row past S matches no key; its output is never stored
    const float qma = qa < S ? sM[qa] : __int_as_float(0x7fc00000);
    const float qmb = qb < S ? sM[qb] : __int_as_float(0x7fc00000);
    float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
    // fresh bases: the tile loop would otherwise hold the products' loop-
    // invariant descriptors in registers beside the scores
    issue_scores<NK, D>(sc, fresh(sQ), fresh(sK), nullptr, NK * 128);
    if (DROP)  // the tile's keep bits while the product runs
      build_keep(keep, QT, Sh::WORDS, Sh::KSTRIDE, drop, prow0 + q0, 0, tid,
                 128);
    wgmma_wait<0>();
    fence_acc(sc);
    if (t + 1 < t_end) q_free_arrive(wg);  // the Q buffer is the other's
    if (DROP) warpgroup_sync(wg);          // the keep table is complete
    mask_scores<NK>(sc, sM, qma, qmb, sm_scale, t4, ma, mb);
    ma = quad_max(ma);
    mb = quad_max(mb);
    exp_scores<NK>(sc, ma, mb, la, lb);
    la = quad_sum(la);
    lb = quad_sum(lb);
    probs_times_v<NK, D, DROP>(sc, o, fresh(sV), nullptr, la, lb, keep,
                               Sh::KSTRIDE, ra, 0, drop, t4, false);
    wgmma_wait<0>();
    fence_acc(o);
    if (stats != nullptr && t4 == 0) {
      if (qa < S) {
        stats[prow0 + qa] = ma;
        stats[bhs + prow0 + qa] = la;
      }
      if (qb < S) {
        stats[prow0 + qb] = mb;
        stats[bhs + prow0 + qb] = lb;
      }
    }
    // o[4 jj + e]: columns 8 jj + 2 t (+ 1), the three panels' m64n64
    // accumulators in order
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int col = head * D + jj * 8 + 2 * t4;
      if (qa < S)
        *reinterpret_cast<unsigned*>(ctx + (row0 + qa) * H + col) =
            pack_bf16x2(o[4 * jj], o[4 * jj + 1]);
      if (qb < S)
        *reinterpret_cast<unsigned*>(ctx + (row0 + qb) * H + col) =
            pack_bf16x2(o[4 * jj + 2], o[4 * jj + 3]);
    }
  }
}

template <int NK, bool DROP>
int launch_wgmma192(const void* q, const void* k, const void* v, int ld,
                    const float* mask, void* ctx, float* stats, int B, int S,
                    int n_heads, float sm_scale, const DropParams& drop,
                    cudaStream_t stream) {
  using Sh = Shape192<NK>;
  static int per_sm = 0;  // blocks an SM runs
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        seg_attn192_wgmma_kernel<NK, DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, seg_attn192_wgmma_kernel<NK, DROP>, 256, Sh::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int n_qt = (S + QT - 1) / QT;
  const int tpb = tiles_per_block(n_qt, B * n_heads, per_sm * sm_count(), 2);
  dim3 grid((n_qt + tpb - 1) / tpb, n_heads, B);
  seg_attn192_wgmma_kernel<NK, DROP><<<grid, 256, Sh::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), ld, mask, static_cast<bf16*>(ctx), stats,
      S, tpb, sm_scale, drop);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++wgmma_launches[2];
  return (int)e;
}

// ---------------------------------------------------------------------- //
// The wgmma kernel at d = 192, 256 < S <= 512: K and V streamed
// ---------------------------------------------------------------------- //

// A block's shared memory past 256 keys: 1024-byte alignment slack, the Q
// tile, a ring of two 64-key K tiles, one V tile (each 64 rows of three
// 128-byte-swizzled panels, 24 KB), the key segment ids, the tile's keep
// table: 103.25 KB, two blocks an SM.
constexpr int LONG192_SMEM = 1024 + 4 * Long192::TB + Long192::MAXK * 4 +
                             QT * Long192::KSTRIDE * 4;

// One block (one warpgroup): (element, head) = (blockIdx.z, blockIdx.y),
// query tiles blockIdx.x * tpb .. (+ tpb, at most ceil(S / 64)).  K and V
// (384 KB at S = 512) stay in global memory and pass through shared memory
// a 64-key tile at a time, each read twice a query tile.  Sweep 1 issues
// S = Q K^T per 64-key chunk (issue_scores at W = 64: the 12 k16 steps of
// the S <= 256 kernel's chunk, whose bits the backward rebuilds) and
// reduces the row max and sum across chunks, the sum rescaled as the max
// grows (l exp(m0 - m) + the chunk's exps); the chunk's keep bits are
// drawn while its product runs.  Sweep 2 issues each chunk's scores
// again, normalises them with the row's max and sum, drops them, rounds
// them to bf16 and feeds them from registers to o += P V (probs_times_v).
// A step's next K tile (and in sweep 2 its V tile) is copied while its
// score product runs; the SM's other block fills the waits.  A step's
// barrier covers the ring: each step waits for its products, so every
// slot a copy refills was read in the step before.
template <bool DROP>
__global__ void __launch_bounds__(128, 2)
    seg_attn192_long_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, int ld,
                            const float* __restrict__ mask,
                            bf16* __restrict__ ctx, float* __restrict__ stats,
                            int S, int tpb, float sm_scale, DropParams drop) {
  constexpr int D = 192;
  using Sh = Long192;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + Sh::TB;  // two slots
  unsigned char* sV = sK + 2 * Sh::TB;
  float* sM = reinterpret_cast<float*>(sV + Sh::TB);
  unsigned* keep = reinterpret_cast<unsigned*>(sM + Sh::MAXK);

  const int head = blockIdx.y, elem = blockIdx.z, n_heads = gridDim.y;
  const int t0 = blockIdx.x * tpb;
  const int t_end = min((S + QT - 1) / QT, t0 + tpb);
  const int n_kt = (S + QT - 1) / QT;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;  // Philox row of query 0
  const int H = n_heads * D;
  const size_t off = row0 * ld + head * D;
  const bf16* k_src = k + off;
  const bf16* v_src = v + off;
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = (tid >> 5) * 16 + g;  // this thread's first row of a tile
  const size_t bhs = (size_t)gridDim.z * n_heads * S;

  // the key segment ids (NaN past S: such a key matches no query)
  for (int j = tid; j < n_kt * QT; j += 128)
    sM[j] = j < S ? mask[row0 + j] : __int_as_float(0x7fc00000);
  float sc[QT / 2], o[D / 2];
  for (int t = t0; t < t_end; ++t) {
    const int q0 = t * QT, qa = q0 + ra, qb = qa + 8;
    copy_rows<D>(sQ, q + off, ld, q0, QT, S, tid, 128);
    copy_rows<D>(sK, k_src, ld, 0, QT, S, tid, 128);
    cp_async_commit();
    float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
    float qma = 0.f, qmb = 0.f;
    for (int u = 0; u < 2 * n_kt; ++u) {
      const bool second = u >= n_kt;
      const int c = second ? u - n_kt : u;
      // K of step u has landed, and every thread is past step u - 1
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
      if (u == 0) {  // a query row past S matches no key; never stored
        qma = qa < S ? sM[qa] : __int_as_float(0x7fc00000);
        qmb = qb < S ? sM[qb] : __int_as_float(0x7fc00000);
      }
      if (second)  // this chunk's V, read after the softmax
        copy_rows<D>(sV, v_src, ld, c * QT, QT, S, tid, 128);
      cp_async_commit();
      if (u + 1 < 2 * n_kt)  // the next step's K into the other slot
        copy_rows<D>(sK + ((u + 1) & 1) * Sh::TB, k_src, ld,
                     (u + 1 < n_kt ? u + 1 : u + 1 - n_kt) * QT, QT, S, tid,
                     128);
      cp_async_commit();
      issue_scores<QT, D>(sc, fresh(sQ), fresh(sK) + (u & 1) * Sh::TB,
                          nullptr, QT * 128);
      if (DROP && !second)  // the chunk's keep bits while the product runs
        build_keep(keep + 2 * c, QT, 2, Sh::KSTRIDE, drop, prow0 + q0, c * QT,
                   tid, 128);
      wgmma_wait<0>();
      fence_acc(sc);
      if (!second) {
        float ca = -INFINITY, cb = -INFINITY;
        mask_scores<QT>(sc, sM + c * QT, qma, qmb, sm_scale, t4, ca, cb);
        ca = fmaxf(ma, quad_max(ca));
        cb = fmaxf(mb, quad_max(cb));
        la *= expf(ma - ca);  // 0 at the first chunk (m = -inf, l = 0)
        lb *= expf(mb - cb);
        ma = ca;
        mb = cb;
        exp_scores<QT>(sc, ma, mb, la, lb);
        if (c + 1 == n_kt) {
          la = quad_sum(la);
          lb = quad_sum(lb);
        }
      } else {
        float xa = -INFINITY, xb = -INFINITY;  // unused row maxima
        float ya = 0.f, yb = 0.f;              // unused sums
        mask_scores<QT>(sc, sM + c * QT, qma, qmb, sm_scale, t4, xa, xb);
        exp_scores<QT>(sc, ma, mb, ya, yb);
        cp_async_wait<1>();  // V has landed (the next K may not have)
        fence_proxy_async();
        __syncthreads();
        probs_times_v<QT, D, DROP>(sc, o, fresh(sV), nullptr, la, lb, keep,
                                   Sh::KSTRIDE, ra, 2 * c, drop, t4, c > 0);
        wgmma_wait<0>();
        fence_acc(o);
      }
    }
    if (stats != nullptr && t4 == 0) {
      if (qa < S) {
        stats[prow0 + qa] = ma;
        stats[bhs + prow0 + qa] = la;
      }
      if (qb < S) {
        stats[prow0 + qb] = mb;
        stats[bhs + prow0 + qb] = lb;
      }
    }
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int col = head * D + jj * 8 + 2 * t4;
      if (qa < S)
        *reinterpret_cast<unsigned*>(ctx + (row0 + qa) * H + col) =
            pack_bf16x2(o[4 * jj], o[4 * jj + 1]);
      if (qb < S)
        *reinterpret_cast<unsigned*>(ctx + (row0 + qb) * H + col) =
            pack_bf16x2(o[4 * jj + 2], o[4 * jj + 3]);
    }
    __syncthreads();  // every product of the tile is done: Q, K, V free
  }
}

template <bool DROP>
int launch_long192(const void* q, const void* k, const void* v, int ld,
                   const float* mask, void* ctx, float* stats, int B, int S,
                   int n_heads, float sm_scale, const DropParams& drop,
                   cudaStream_t stream) {
  static int per_sm = 0;  // blocks an SM runs
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        seg_attn192_long_kernel<DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, LONG192_SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, seg_attn192_long_kernel<DROP>, 128, LONG192_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int n_qt = (S + QT - 1) / QT;
  const int tpb = tiles_per_block(n_qt, B * n_heads, per_sm * sm_count(), 1);
  dim3 grid((n_qt + tpb - 1) / tpb, n_heads, B);
  seg_attn192_long_kernel<DROP><<<grid, 128, LONG192_SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), ld, mask, static_cast<bf16*>(ctx), stats,
      S, tpb, sm_scale, drop);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++wgmma_launches[2];
  return (int)e;
}

template <bool DROP>
int launch_wgmma192_s(const void* q, const void* k, const void* v, int ld,
                      const float* mask, void* ctx, float* stats, int B,
                      int S, int n_heads, float sm_scale,
                      const DropParams& drop, cudaStream_t st) {
#define NBK_WGMMA192(NK)                                                  \
  return launch_wgmma192<NK, DROP>(q, k, v, ld, mask, ctx, stats, B, S,    \
                                   n_heads, sm_scale, drop, st)
  if (S <= 64) NBK_WGMMA192(64);
  if (S <= 96) NBK_WGMMA192(96);
  if (S <= 128) NBK_WGMMA192(128);
  if (S <= 160) NBK_WGMMA192(160);
  if (S <= 192) NBK_WGMMA192(192);
  if (S <= 256) NBK_WGMMA192(256);
#undef NBK_WGMMA192
  if (S <= Long192::MAXK)
    return launch_long192<DROP>(q, k, v, ld, mask, ctx, stats, B, S, n_heads,
                                sm_scale, drop, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------- //
// The mma.sync kernel: every d <= 256, d % 8 == 0, but 64 (and 96 at S
// <= 256)
// ---------------------------------------------------------------------- //

constexpr int KT = 64;  // keys per tile

template <int D>
size_t smem_bytes(int S) {
  return (size_t)3 * Tile<D>::ELEMS * sizeof(bf16) +
         (size_t)S * sizeof(float) +
         (size_t)ROWS * keep_stride(S) * sizeof(unsigned);
}

// Blocks per SM each instance is built for (registers <= 65536 / (128 x
// blocks)): the d = 32 and 64 instances at 4 (128 registers: 130 instead
// cost this kernel 20% at d = 64, seq 256 on the H100), the d = 96 ones
// at 3 (168 registers: the q fragments, the accumulator and a tile's
// scores take 104, and 3 blocks of 43 KB fit the SM's shared memory at
// seq 256; 2 blocks ran 22% slower at 32 x 256 x 8 heads with dropout on
// the H100), the d = 128 ones where they fall unbounded, the d = 192 and
// 256 ones at 1 (their q fragments and accumulators alone take 144 and
// 192 registers).  q, k, v: row 0, column 0 of the head block of each
// operand, ld its row stride (elements); the head is dh <= D columns wide
// (columns past dh are zeros in the tiles); ctx has rows of n_heads * dh.
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, D <= 64     ? 4
                                           : D == 96  ? 3
                                           : D == 128 ? (DROP ? 2 : 3)
                                                      : 1)
    seg_attention_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, int ld,
                         const float* __restrict__ mask,
                         bf16* __restrict__ ctx, float* __restrict__ stats,
                         int S, int dh, float sm_scale, DropParams drop) {
  constexpr int LD = Tile<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + Tile<D>::ELEMS;
  bf16* sV = sK + Tile<D>::ELEMS;
  float* sM = reinterpret_cast<float*>(sV + Tile<D>::ELEMS);
  unsigned* sKeep = reinterpret_cast<unsigned*>(sM + S);
  const int kstride = keep_stride(S);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * ROWS, head = blockIdx.y, elem = blockIdx.z;
  const int n_heads = gridDim.y;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;  // Philox row of query 0
  const int H = n_heads * dh;
  const size_t off = row0 * ld + head * dh;
  const bf16* q_src = q + off;
  const bf16* k_src = k + off;
  const bf16* v_src = v + off;

  for (int j = threadIdx.x; j < S; j += THREADS) sM[j] = mask[row0 + j];
  load_tile<D>(sQ, q_src, q0, S, ld, dh);
  cp_async_commit();
  if (DROP)
    build_keep(sKeep, ROWS, (S + 31) / 32, kstride, drop, prow0 + q0, 0);
  cp_async_wait<0>();
  __syncthreads();

  unsigned qf[D / 16][4];
  load_a<D>(qf, sQ + warp * 16 * LD, lane);

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
    load_tile<D>(sK, k_src, kt * KT, S, ld, dh);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float sc[8][4];
    tile_scores<D>(sc, qf, sK, sM + kt * KT, kt * KT, S, qma, qmb, sm_scale,
                   lane);
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
  if (stats != nullptr && t4 == 0) {
    const size_t bhs = (size_t)gridDim.z * n_heads * S;
    if (qa < S) {
      stats[prow0 + qa] = ma;
      stats[bhs + prow0 + qa] = la;
    }
    if (qb < S) {
      stats[prow0 + qb] = mb;
      stats[bhs + prow0 + qb] = lb;
    }
  }

  // pass 2: the same scores, normalised, dropped, rounded to bf16, times V
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  const int ra = warp * 16 + g;  // this thread's rows in the keep table
  const float rla = __frcp_rn(la), rlb = __frcp_rn(lb);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<D>(sK, k_src, kt * KT, S, ld, dh);
    load_tile<D>(sV, v_src, kt * KT, S, ld, dh);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float sc[8][4];
    tile_scores<D>(sc, qf, sK, sM + kt * KT, kt * KT, S, qma, qmb, sm_scale,
                   lane);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int nt = 2 * ks + j;
          p[j][c] = c < 2 ? div_row(expf(sc[nt][c] - ma), la, rla)
                          : div_row(expf(sc[nt][c] - mb), lb, rlb);
          if (DROP) {
            const int key = kt * KT + nt * 8 + 2 * t4 + (c & 1);
            // the table holds keys < S; p is 0 past S anyway
            p[j][c] = key < S &&
                              kept(sKeep, kstride, ra + (c >> 1) * 8, key)
                          ? __fmul_rn(p[j][c], drop.inv_keep)
                          : 0.f;
          }
        }
      }
      mma_chunk<D>(acc, p, sV + ks * 16 * LD, lane);
    }
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    if (dt * 8 >= dh) continue;  // a padded head's zero columns
    const int col = head * dh + dt * 8 + 2 * t4;
    if (qa < S)
      *reinterpret_cast<unsigned*>(ctx + (row0 + qa) * H + col) =
          pack_bf16x2(acc[dt][0], acc[dt][1]);
    if (qb < S)
      *reinterpret_cast<unsigned*>(ctx + (row0 + qb) * H + col) =
          pack_bf16x2(acc[dt][2], acc[dt][3]);
  }
}

template <int D, bool DROP>
int launch_kernel(const void* q, const void* k, const void* v, int ld,
                  const float* mask, void* ctx, float* stats, int B, int S,
                  int n_heads, int dh, float sm_scale, const DropParams& drop,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(S);
  cudaError_t e = cudaFuncSetAttribute(
      seg_attention_kernel<D, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + ROWS - 1) / ROWS, n_heads, B);
  seg_attention_kernel<D, DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), ld, mask, static_cast<bf16*>(ctx), stats,
      S, dh, sm_scale, drop);
  return (int)cudaGetLastError();
}

// the serving forward (no dropout) compiles without the keep-bit code
template <int D>
int launch(const void* q, const void* k, const void* v, int ld,
           const float* mask, void* ctx, float* stats, int B, int S,
           int n_heads, int dh, float sm_scale, const DropParams& drop,
           cudaStream_t stream) {
  if (drop.on)
    return launch_kernel<D, true>(q, k, v, ld, mask, ctx, stats, B, S,
                                  n_heads, dh, sm_scale, drop, stream);
  return launch_kernel<D, false>(q, k, v, ld, mask, ctx, stats, B, S,
                                 n_heads, dh, sm_scale, drop, stream);
}

}  // namespace

extern "C" {

// q, k, v: (B*S, ld) bf16 row-major with each operand's (n_heads * d)
// columns starting at its pointer (16-byte aligned, ld % 8 == 0) -- the
// q | k | v column blocks of one (B*S, 3h) QKV buffer (ld = 3h), or
// (B, S, n_heads, d) tensors (ld = n_heads * d); mask (B, S) f32 segment
// ids -> ctx (B*S, n_heads * d) bf16, on the instance the caller names:
// 0, the wgmma kernel (d = 64 or 192 with S <= 512, d = 96 with S <=
// 256), or the width of a mma.sync instance (32, 64, 96, 128, 192 or 256,
// at least d, any d % 8 == 0); any other instance, d or S is refused.
// stats, if not null, is (2, B, n_heads, S) f32 and receives each row's
// max and sum of exp.  Prob dropout when drop_on (seed,
// stream, thresh, inv_keep as in philox.cuh).
int nbk_seg_attention(const void* q, const void* k, const void* v, int ld,
                      const float* mask, void* ctx, float* stats, int B,
                      int S, int n_heads, int d, int instance,
                      float sm_scale, unsigned long long seed, int stream,
                      unsigned thresh, float inv_keep, int drop_on,
                      void* cuda_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const DropParams drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  if (S <= 0 || d <= 0 || d % 8) return (int)cudaErrorInvalidValue;
#define NBK_WGMMA_S(D)                                                   \
  return drop.on ? launch_wgmma_s<D, true>(q, k, v, ld, mask, ctx, stats, \
                                           B, S, n_heads, sm_scale, drop, \
                                           s)                            \
                 : launch_wgmma_s<D, false>(q, k, v, ld, mask, ctx,      \
                                            stats, B, S, n_heads,        \
                                            sm_scale, drop, s)
  if (instance == 0) {  // S past the kernel's windows is refused there
    if (d == WD) NBK_WGMMA_S(64);
    if (d == 96) NBK_WGMMA_S(96);
    if (d == 192)
      return drop.on ? launch_wgmma192_s<true>(q, k, v, ld, mask, ctx, stats,
                                               B, S, n_heads, sm_scale, drop,
                                               s)
                     : launch_wgmma192_s<false>(q, k, v, ld, mask, ctx,
                                                stats, B, S, n_heads,
                                                sm_scale, drop, s);
    return (int)cudaErrorInvalidValue;
  }
#undef NBK_WGMMA_S
  if (d > instance) return (int)cudaErrorInvalidValue;
#define NBK_SEG_ATTN(D)                                                   \
  case D:                                                                 \
    return launch<D>(q, k, v, ld, mask, ctx, stats, B, S, n_heads, d,     \
                     sm_scale, drop, s);
  switch (instance) {
    NBK_SEG_ATTN(32)
    NBK_SEG_ATTN(64)
    NBK_SEG_ATTN(96)
    NBK_SEG_ATTN(128)
    NBK_SEG_ATTN(192)
    NBK_SEG_ATTN(256)
  }
#undef NBK_SEG_ATTN
  return (int)cudaErrorInvalidValue;
}

// Launches of the wgmma kernels since the library was loaded, at head dim
// d (64, 96 or 192; 0: all three; -1 for any other d): which instance ran.
long long nbk_seg_attention_wgmma_launches(int d) {
  return d == 64    ? wgmma_launches[0]
         : d == 96  ? wgmma_launches[1]
         : d == 192 ? wgmma_launches[2]
         : d == 0   ? wgmma_launches[0] + wgmma_launches[1] + wgmma_launches[2]
                    : -1;
}

}  // extern "C"
