// Tiled flash-attention forward: online softmax over 64-key tiles, for any
// sequence length.
//
// Replaces nbest_asr_tpu/ops/flash_attention.py:_fwd_kernel (:99), the
// TPU's tiled forward over a (b, h, q-block, kv-block) grid, and the
// wrapper's transposes and padding around it (:644-672):
//   s   = q k^T * sm_scale, MASK_VALUE where the segment ids differ
//   m'  = max(m, rowmax(s));  alpha = exp(m - m');  p = exp(s - m')
//   l'  = alpha l + rowsum(p)            (the UNdropped probs)
//   acc = alpha acc + drop(p) v          (p * f32(1 / (1 - rate)) kept)
//   o   = bf16(acc * (1 / l)),  lse = m + log(max(l, 1e-30))   (f32)
// The running max, sum and accumulator are f32; MASK_VALUE is JAX's
// finite -0.7 * FLT_MAX, never -inf, so a tile whose keys are all in
// other segments for a row gives p = 1 there (not NaN: -inf - -inf is) and
// is rescaled away by alpha once that row's own segment arrives.  Keys
// past S are -inf (the TPU wrapper pads them with mask -1, which no query
// carries).  q, k and v are read in their (b, s, heads, d) layout by row
// stride and column offset (from one (n, 3h) QKV buffer, or standalone
// tensors), o is written (b, s, heads, d) and lse (b, heads, s): no
// transposes and no padding.  Prob dropout is Philox stream 3 at row
// (elem * n_heads + head) * S + q, column k -- the single-block kernel's
// mask (seg_attention.cu), whatever the tiling.  The P . V product takes P
// rounded to bf16 unnormalised, as FlashAttention does (the TPU kernel
// multiplies in f32 at HIGHEST precision).
//
// Three kernels here and the chunked family; nbk_flash_fwd picks by head
// dim, and none falls back to another:
//   d = 64 (any S)        the wgmma + TMA kernel (section 2)
//   d = 96 (any S)        its twin on 96-column tiles (section 3)
//   every other d <= 256  the mma.sync kernel (section 1), on its
//   with d % 8 == 0       instance of width 32, 64, 96, 128, 192 or 256
//                         (attention.cuh, instance_width: a d between two
//                         widths runs on the wider, its columns past d
//                         zero-filled on load and never stored; d = 40 ..
//                         56 on the 64-wide instance and 72 .. 88 on the
//                         96-wide one, which run only such padded heads:
//                         a TMA box as wide as the instance would read
//                         the next head's columns)
//   d > 256, d % 8 != 0   chunked_fwd (attention_chunked.cu), the head dim
//                         in 64-column chunks at any alignment
//
// The mma.sync kernel (FlashAttention-2): one block per (element, head,
// 64-query tile), 4 warps x 16 query rows; the q fragments stay in
// registers for the whole key sweep; each 64-key tile of K and V arrives
// by cp.async into one of two shared buffers while the previous tile is
// computed, with its 64 segment ids and its 64 x 64 keep bits (one Philox
// call per four probs, drawn once per block into a shared bit table,
// attention.cuh).  The score C fragments become, after the exp, the A
// fragments of P . V.
//
// The wgmma + TMA kernel at d = 64 (at 96 the same on 96-column tiles),
// on the backward pair's pieces
// (flash_wgmma.cuh) with an online softmax in place of dP: a block owns
// 256 queries as four warpgroups of 64, which share each 64-key K and V
// tile.  The block's Q arrives once by TMA; warp 0 fills a ring of
// FSTAGES slots two tiles ahead with K and V (TMA, 3-D maps, so keys past
// S are zero-filled within each element) and each slot's segment ids.
// Each warpgroup issues S = Q K^T on wgmma from shared memory (m64n64k16,
// both K-major) and, while it runs, draws its rows' keep bits (8 Philox
// calls a lane, the bits handed out by shuffles); the softmax stays in
// registers in log2 units (scores times sm_scale log2 e, exp2 on the
// special-function unit, row maxima and the rescale by quad shuffles),
// and the dropped probs, packed as bf16 A fragments, multiply the slot's V
// read MN-major: O += P V with A from registers.  The mask sentinel is
// MASK_VALUE itself, taken after the scaling (MASK_VALUE log2 e would
// overflow to -inf).  lse goes out in natural log, m ln 2 + log(l), the
// statistic the backward pair reads.
//
// Why this shape (chip_time_attention.py's flash rows on variant
// checkouts, PERF.md): the kernel is paced by instruction issue --
// some 13 instructions per (query, key) of softmax and, with dropout, the
// Philox multiplies, which share the FMA pipe -- and by how well its warps
// hide each other's latencies.  Four warpgroups (four warps a scheduler)
// ran a sixth faster than two without dropout, 5% with it; a producer
// warpgroup beside them held all 640 threads to 96 registers, where the
// Philox draws spilled, so there is none: 512 threads keep 128 registers.
// Two blocks an SM (80 registers) spilled and serialised the products;
// issuing the next tile's S before this tile's softmax (FlashAttention-3's
// overlap, two warpgroups) made ptxas serialise them too.
//
// What bounds it on the H100: 4 b h s^2 d tensor-core operations against
// 8 b s h + 4 b s + 4 b h s bytes -- at s = 1024, d = 64 about 500
// operations a byte, above the card's 295: the MMA rate bounds it (0.104
// ms at route B's 32 x 1024 x 12 heads, and at the quality encoder's 32 x
// 1024 x 8 heads of 96, where section 3 takes 0.57 ms, 0.30 without
// dropout).  With dropout the Philox keep bits, one call per four (query,
// key) pairs with some 18 integer multiplies each, take the integer pipe
// longer than the products take the tensor cores (PERF.md).
#include "attention_chunked.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace nbk;
using namespace nbk::attn;
using namespace nbk::flash;

// -------------------------------------------------------------------- //
// 1. The mma.sync kernel, every d <= 256, d % 8 == 0, but 64 and 96
// -------------------------------------------------------------------- //

constexpr int KT = 64;       // keys per tile
constexpr int KWORDS = 2;    // keep words per query row of a tile
constexpr int KSTRIDE = 3;   // odd: a fragment column's 8 rows, 8 banks

template <int D>
size_t fwd_smem() {
  return (size_t)5 * Tile<D>::ELEMS * sizeof(bf16) +
         (size_t)2 * KT * sizeof(float) +
         (size_t)2 * ROWS * KSTRIDE * sizeof(unsigned);
}

// The next tile's K and V (cp.async, one commit group), segment ids and
// keep bits into buffer b.
template <int D, bool DROP>
__device__ __forceinline__ void stage_tile(bf16* sK, bf16* sV, float* sMk,
                                           unsigned* sKeep,
                                           const bf16* k_src,
                                           const bf16* v_src, int ld,
                                           const float* mrow, int k0, int S,
                                           int dh, const DropParams& drop,
                                           int prow_q0) {
  load_tile<D>(sK, k_src, k0, S, ld, dh);
  load_tile<D>(sV, v_src, k0, S, ld, dh);
  cp_async_commit();
  for (int j = threadIdx.x; j < KT; j += THREADS)
    sMk[j] = k0 + j < S ? mrow[k0 + j] : 0.f;
  if (DROP) build_keep(sKeep, ROWS, KWORDS, KSTRIDE, drop, prow_q0, k0);
}

// Blocks per SM: 4 at d = 32 and 64 (128 registers), 3 at d = 96 (67 KB of
// shared memory; 168 registers, where the dropout instance spills 12
// bytes: 9% faster than 2 blocks at 32 x 1024 x 8 heads on the H100, when
// it ran d = 96 itself; it runs the padded d = 72 .. 88 now), 2 at
// d = 128 (87 KB; the fragments and the accumulator take ~96 registers
// before the scores), 1 at d = 192 and 256 (128 and 169 KB).  The head is
// dh <= D columns wide (columns past dh are zeros in the tiles); o has rows
// of n_heads * dh.
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, D <= 64    ? 4
                                           : D == 96  ? 3
                                           : D == 128 ? 2
                                                      : 1)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, int ld,
                     const float* __restrict__ mask, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, int dh, float sm_scale,
                     DropParams drop) {
  constexpr int LD = Tile<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + Tile<D>::ELEMS;          // two buffers
  bf16* sV = sK + 2 * Tile<D>::ELEMS;      // two buffers
  float* sMk = reinterpret_cast<float*>(sV + 2 * Tile<D>::ELEMS);
  unsigned* sKeep = reinterpret_cast<unsigned*>(sMk + 2 * KT);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * ROWS, head = blockIdx.y, elem = blockIdx.z;
  const int n_heads = gridDim.y;
  const int H = n_heads * dh;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;  // Philox row of query 0
  const size_t off = row0 * ld + head * dh;
  const bf16* k_src = k + off;
  const bf16* v_src = v + off;
  const float* mrow = mask + row0;

  load_tile<D>(sQ, q + off, q0, S, ld, dh);
  cp_async_commit();
  stage_tile<D, DROP>(sK, sV, sMk, sKeep, k_src, v_src, ld, mrow, 0, S, dh,
                      drop, prow0 + q0);

  const int g = lane >> 2, t4 = lane & 3;
  const int ra = warp * 16 + g;  // this thread's rows in the keep table
  const int qa = q0 + ra, qb = qa + 8;
  // a query row past S matches no key (NaN == x is false); its output is
  // never stored
  const float nan = __int_as_float(0x7fc00000);
  const float qma = qa < S ? mrow[qa] : nan, qmb = qb < S ? mrow[qb] : nan;
  const int n_kt = (S + KT - 1) / KT;

  unsigned qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int b = kt & 1;
    if (kt + 1 < n_kt) {
      stage_tile<D, DROP>(sK + (b ^ 1) * Tile<D>::ELEMS,
                          sV + (b ^ 1) * Tile<D>::ELEMS, sMk + (b ^ 1) * KT,
                          sKeep + (b ^ 1) * ROWS * KSTRIDE, k_src, v_src, ld,
                          mrow, (kt + 1) * KT, S, dh, drop, prow0 + q0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) load_a<D>(qf, sQ + warp * 16 * LD, lane);
    const bf16* tK = sK + b * Tile<D>::ELEMS;
    const bf16* tV = sV + b * Tile<D>::ELEMS;
    const unsigned* tab = sKeep + b * ROWS * KSTRIDE;

    float sc[8][4];
    tile_scores<D>(sc, qf, tK, sMk + b * KT, kt * KT, S, qma, qmb, sm_scale,
                   lane);
    float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      ta = fmaxf(ta, fmaxf(sc[nt][0], sc[nt][1]));
      tb = fmaxf(tb, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      ta = fmaxf(ta, __shfl_xor_sync(0xffffffffu, ta, x));
      tb = fmaxf(tb, __shfl_xor_sync(0xffffffffu, tb, x));
    }
    // every tile holds a key below S, so na and nb are finite; the first
    // tile's alpha is exp(-inf) = 0
    const float na = fmaxf(ma, ta), nb = fmaxf(mb, tb);
    const float alpha_a = expf(ma - na), alpha_b = expf(mb - nb);
    la *= alpha_a;
    lb *= alpha_b;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha_a;
      acc[dt][1] *= alpha_a;
      acc[dt][2] *= alpha_b;
      acc[dt][3] *= alpha_b;
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int nt = 2 * ks + j;
          const float e = expf(sc[nt][c] - (c < 2 ? na : nb));
          if (c < 2)
            la += e;
          else
            lb += e;
          p[j][c] = e;
          if (DROP) {
            const int key = nt * 8 + 2 * t4 + (c & 1);  // within the tile
            p[j][c] = kept(tab, KSTRIDE, ra + (c >> 1) * 8, key)
                          ? __fmul_rn(e, drop.inv_keep)
                          : 0.f;
          }
        }
      }
      mma_chunk<D>(acc, p, tV + ks * 16 * LD, lane);
    }
    ma = na;
    mb = nb;
    __syncthreads();  // buffer b is restaged next iteration
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, x);
    lb += __shfl_xor_sync(0xffffffffu, lb, x);
  }
  const float ia = la == 0.f ? 1.f : 1.f / la;
  const float ib = lb == 0.f ? 1.f : 1.f / lb;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    if (dt * 8 >= dh) continue;  // a padded head's zero columns
    const int col = head * dh + dt * 8 + 2 * t4;
    if (qa < S)
      *reinterpret_cast<unsigned*>(o + (row0 + qa) * H + col) =
          pack_bf16x2(acc[dt][0] * ia, acc[dt][1] * ia);
    if (qb < S)
      *reinterpret_cast<unsigned*>(o + (row0 + qb) * H + col) =
          pack_bf16x2(acc[dt][2] * ib, acc[dt][3] * ib);
  }
  if (t4 == 0) {
    if (qa < S) lse[prow0 + qa] = ma + logf(fmaxf(la, 1e-30f));
    if (qb < S) lse[prow0 + qb] = mb + logf(fmaxf(lb, 1e-30f));
  }
}

template <int D, bool DROP>
int launch_kernel(const void* q, const void* k, const void* v, int ld,
                  const float* mask, void* o, float* lse, int B, int S,
                  int n_heads, int dh, float sm_scale, const DropParams& drop,
                  cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + ROWS - 1) / ROWS, n_heads, B);
  flash_fwd_kernel<D, DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), ld, mask, static_cast<bf16*>(o), lse, S,
      dh, sm_scale, drop);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, int ld,
           const float* mask, void* o, float* lse, int B, int S, int n_heads,
           int dh, float sm_scale, const DropParams& drop,
           cudaStream_t stream) {
  if (drop.on)
    return launch_kernel<D, true>(q, k, v, ld, mask, o, lse, B, S, n_heads,
                                  dh, sm_scale, drop, stream);
  return launch_kernel<D, false>(q, k, v, ld, mask, o, lse, B, S, n_heads,
                                 dh, sm_scale, drop, stream);
}

// -------------------------------------------------------------------- //
// 2. The wgmma + TMA kernel, d = 64 (any S)
// -------------------------------------------------------------------- //

constexpr float LN2 = 0.6931471805599453f;
constexpr int FBLOCK = 256;    // queries a block owns: four warpgroups
constexpr int FTHREADS = 512;  // no producer warpgroup: 128 registers each
constexpr int FSTAGES = 4;     // ring slots; warp 0 fills two tiles ahead

// One key tile of the online softmax for a thread's rows g and g + 8 of
// its warp (segment ids qma, qmb; kid: the tile's key segment ids from
// the thread's first fragment column; n: the tile's keys below S).  The
// scores s (C fragments) become x = s sm_scale log2 e (sc2), MASK_VALUE
// where the segments differ, -inf past S; the row maxima ma, mb (log2
// units) and this thread's share of the row sums la, lb take the tile in,
// p = 2^(x - m') summed undropped, and drop(p) is packed into pa as bf16
// A fragments.  -> the rows' rescale factors 2^(m - m').
template <bool DROP>
__device__ __forceinline__ float2 softmax_tile(
    float (&s)[32], unsigned (&pa)[16], const float* kid, float qma,
    float qmb, int n, float sc2, float ik, const KeepQ<DROP>& keep, int t4,
    float& ma, float& mb, float& la, float& lb) {
  // x = s sm_scale log2 e; MASK_VALUE where the segments differ
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 km = *reinterpret_cast<const float2*>(kid + 8 * jj);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * jj + e;
      s[i] = ((e & 1) ? km.y : km.x) == (e < 2 ? qma : qmb) ? s[i] * sc2
                                                            : MASK_VALUE;
    }
  }
  if (n < QT) {  // the last tile: keys past S are -inf
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (8 * (i >> 2) + 2 * t4 + (i & 1) >= n) s[i] = -INFINITY;
  }
  float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    ta = fmaxf(ta, fmaxf(s[4 * jj], s[4 * jj + 1]));
    tb = fmaxf(tb, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
  }
  // every tile holds a key below S, so na and nb are finite; the first
  // tile's alpha is 2^-inf = 0
  const float na = fmaxf(ma, quad_max(ta)), nb = fmaxf(mb, quad_max(tb));
  const float2 alpha = make_float2(ex2(ma - na), ex2(mb - nb));
  ma = na;
  mb = nb;
  la *= alpha.x;
  lb *= alpha.y;
  // p = 2^(x - m'), summed undropped; drop(p) packed as A fragments
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool lo = e < 2;
      const float p = ex2(s[4 * jj + e] - (lo ? na : nb));
      if (lo)
        la += p;
      else
        lb += p;
      v[e] = !DROP ? p : keep(!lo, jj, e & 1) ? __fmul_rn(p, ik) : 0.f;
    }
    pa[2 * jj] = pack_bf16x2(v[0], v[1]);
    pa[2 * jj + 1] = pack_bf16x2(v[2], v[3]);
  }
  return alpha;
}

// Scales a thread's accumulator rows g (by f.x) and g + 8 (by f.y).
template <int R>
__device__ __forceinline__ void scale_rows(float (&acc)[R], float2 f) {
#pragma unroll
  for (int jj = 0; jj < R / 4; ++jj) {
    acc[4 * jj] *= f.x;
    acc[4 * jj + 1] *= f.x;
    acc[4 * jj + 2] *= f.y;
    acc[4 * jj + 3] *= f.y;
  }
}

// The rows' end: their sums over the quad, lse in natural log (m ln 2 +
// log(l)) at lse[qa] and lse[qa + 8] (rows below S).  -> the factors that
// normalise o, 1 / l (1 where l = 0).
__device__ __forceinline__ float2 finish_rows(float ma, float mb, float la,
                                              float lb, float* lse, int qa,
                                              int S, int t4) {
  la = quad_sum(la);
  lb = quad_sum(lb);
  if (t4 == 0) {
    if (qa < S) lse[qa] = ma * LN2 + logf(fmaxf(la, 1e-30f));
    if (qa + 8 < S) lse[qa + 8] = mb * LN2 + logf(fmaxf(lb, 1e-30f));
  }
  return make_float2(la == 0.f ? 1.f : 1.f / la, lb == 0.f ? 1.f : 1.f / lb);
}

// Shared memory, offsets from a 1024-byte-aligned base: Q of the block's
// 256 queries (four 64-row boxes), the ring's K and V tiles, each slot's
// key segment ids (NaN past S), the barriers (full and empty per slot, one
// for Q).
struct FwdSmem {
  static constexpr int Q = 0, K = Q + 4 * QTILE, V = K + FSTAGES * QTILE;
  static constexpr int IDS = V + FSTAGES * QTILE;
  static constexpr int BAR = IDS + FSTAGES * QT * 4;
  static constexpr int BYTES = 1024 + BAR + (2 * FSTAGES + 1) * 8;
};
static_assert(FwdSmem::BYTES <= 232448, "shared memory");

// Per (element, head, 256 queries), keys innermost.  Warpgroup w owns
// queries 64 w .. + 63 of the block; warp 0 also fills the ring.
template <bool DROP>
__global__ void __launch_bounds__(FTHREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ mask, bf16* __restrict__ o,
    float* __restrict__ lse, int S, float sm_scale, DropParams drop) {
  using L = FwdSmem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* ids = reinterpret_cast<float*>(sm + L::IDS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + FSTAGES;
  uint64_t* resident = empty + FSTAGES;

  const int head = blockIdx.y, elem = blockIdx.z, col = head * WD;
  const int H = gridDim.y * WD;
  const int q0 = blockIdx.x * FBLOCK;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * gridDim.y + head) * S;  // Philox row of query 0
  const int n_kt = (S + QT - 1) / QT;
  const float nan = __int_as_float(0x7fc00000);

  if (threadIdx.x == 0) {
    for (int s = 0; s < FSTAGES; ++s) {
      mbar_init(&full[s], 33);   // the TMA bytes + warp 0's 32 lanes
      mbar_init(&empty[s], 16);  // one arrive per warp
    }
    mbar_init(resident, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int ct = threadIdx.x, cw = ct >> 7;
  const int lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  const bool loader = ct < 32;  // warp 0 fills the ring
  // tile kt's K, V (lane 0, by TMA) and segment ids into its slot
  auto fill = [&](int kt) {
    const int st = kt % FSTAGES, k0 = kt * QT;
    if (lane == 0) {
      mbar_expect_tx(&full[st], 2 * QTILE);
      tma_load(sm + L::K + st * QTILE, &tm_k, &full[st], col, k0, elem);
      tma_load(sm + L::V + st * QTILE, &tm_v, &full[st], col, k0, elem);
    }
    for (int j = lane; j < QT; j += 32)
      ids[st * QT + j] = k0 + j < S ? mask[row0 + k0 + j] : nan;
    mbar_arrive(&full[st]);
  };
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(resident, 4 * QTILE);
#pragma unroll
      for (int h = 0; h < 4; ++h)
        tma_load(sm + L::Q + h * QTILE, &tm_q, resident, col, q0 + h * QT,
                 elem);
    }
    for (int kt = 0; kt < FSTAGES && kt < n_kt; ++kt) fill(kt);
  }
  const int ra = cw * 64 + ((ct >> 5) & 3) * 16 + g;  // block rows ra, +8
  const int qa = q0 + ra, qb = qa + 8;
  // the Philox row this lane draws: row lane / 2 of the warp's 16
  const int drow = prow0 + q0 + (ra - g) + (lane >> 1);
  // a query past S matches no key (NaN); its output is never stored
  const float qma = qa < S ? mask[row0 + qa] : nan;
  const float qmb = qb < S ? mask[row0 + qb] : nan;
  const float sc2 = sm_scale * LOG2E, ik = drop.inv_keep;
  const uint64_t d_q = kmajor(sm + L::Q + cw * QTILE);
  const uint64_t d_k = kmajor(sm + L::K), d_vt = mnmajor(sm + L::V);
  mbar_wait(resident, 0);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  // the running row maxima (log2 units) and this thread's share of the
  // row sums
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    // the slot tile kt - 2 held takes tile kt + 2 once every warp is done
    // with it (rarely a wait: two tiles have passed since)
    if (loader && kt >= 2 && kt + 2 < n_kt) {
      mbar_wait(&empty[(kt - 2) % FSTAGES], ((kt - 2) / FSTAGES) & 1);
      fill(kt + 2);
    }
    const int st = kt % FSTAGES;
    const uint64_t slot = st * TILE_DESC;
    mbar_wait(&full[st], (kt / FSTAGES) & 1);
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(s, d_q + kk * KSTEP, d_k + slot + kk * KSTEP, kk);
    wgmma_commit();
    // the keep bits while the product runs
    const KeepQ<DROP> keep(
        DROP ? draw_rows(drop, drow, kt * QT + 4 * (lane & 1)) : 0u, lane);
    const float* kid = ids + st * QT + 2 * t4;
    wgmma_wait<0>();
    fence_acc(s);
    unsigned pa[16];
    const float2 alpha = softmax_tile<DROP>(s, pa, kid, qma, qmb,
                                            S - kt * QT, sc2, ik, keep, t4,
                                            ma, mb, la, lb);
    scale_rows(acc, alpha);
    fence_acc(acc);
    wgmma_fence();
    issue_rs(acc, pa, d_vt + slot);  // O += drop(P) V
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  const float2 inv = finish_rows(ma, mb, la, lb, lse + prow0, qa, S, t4);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = col + jj * 8 + 2 * t4;
    if (qa < S)
      *reinterpret_cast<unsigned*>(o + (row0 + qa) * H + c) =
          pack_bf16x2(acc[4 * jj] * inv.x, acc[4 * jj + 1] * inv.x);
    if (qb < S)
      *reinterpret_cast<unsigned*>(o + (row0 + qb) * H + c) =
          pack_bf16x2(acc[4 * jj + 2] * inv.y, acc[4 * jj + 3] * inv.y);
  }
}

// -------------------------------------------------------------------- //
// 3. The wgmma + TMA kernel, d = 96 (any S)
// -------------------------------------------------------------------- //

// Section 2's kernel on 96-column tiles (flash_wgmma.cuh's, as the d = 96
// backward pair lays them: a 128-byte- and a 64-byte-swizzled panel, each
// by its own TMA map).  S = Q K^T takes 4 + 2 k16 steps (issue_nt96); O
// += drop(P) V an m64n64 and an m64n32 product with P from registers
// (issue_rs96), 32 + 16 accumulators a thread; the softmax and the keep
// bits are section 2's, the same work per (query, key) pair.  A thread
// holds 16 registers more than at d = 64 (the second panel's
// accumulators) within the same 128, so the descriptors are built at each
// use from 32-bit shared addresses, as the backward pair's are: 128
// registers, no spill.  Three warpgroups a block (168 registers) ran 18%
// slower on the H100 (PERF.md).

// Shared memory, offsets from a 1024-byte-aligned base: FwdSmem's with
// 96-column tiles.
struct Fwd96Smem {
  static constexpr int Q = 0, K = Q + 4 * T96, V = K + FSTAGES * T96;
  static constexpr int IDS = V + FSTAGES * T96;
  static constexpr int BAR = IDS + FSTAGES * QT * 4;
  static constexpr int BYTES = 1024 + BAR + (2 * FSTAGES + 1) * 8;
};
static_assert(Fwd96Smem::BYTES <= 232448, "shared memory");

// Per (element, head, 256 queries), keys innermost.  Warpgroup w owns
// queries 64 w .. + 63 of the block; warp 0 also fills the ring.
template <bool DROP>
__global__ void __launch_bounds__(FTHREADS, 1) flash_fwd96_wgmma_kernel(
    const __grid_constant__ PanelMaps tm_q,
    const __grid_constant__ PanelMaps tm_k,
    const __grid_constant__ PanelMaps tm_v,
    const float* __restrict__ mask, bf16* __restrict__ o,
    float* __restrict__ lse, int S, float sm_scale, DropParams drop) {
  using L = Fwd96Smem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* ids = reinterpret_cast<float*>(sm + L::IDS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + FSTAGES;
  uint64_t* resident = empty + FSTAGES;

  const int head = blockIdx.y, elem = blockIdx.z, col = head * 96;
  const int H = gridDim.y * 96;
  const int q0 = blockIdx.x * FBLOCK;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * gridDim.y + head) * S;  // Philox row of query 0
  const int n_kt = (S + QT - 1) / QT;
  const float nan = __int_as_float(0x7fc00000);

  if (threadIdx.x == 0) {
    for (int s = 0; s < FSTAGES; ++s) {
      mbar_init(&full[s], 33);   // the TMA bytes + warp 0's 32 lanes
      mbar_init(&empty[s], 16);  // one arrive per warp
    }
    mbar_init(resident, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int ct = threadIdx.x, cw = ct >> 7;
  const int lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  const bool loader = ct < 32;  // warp 0 fills the ring
  // tile kt's K, V (lane 0, by TMA) and segment ids into its slot
  auto fill = [&](int kt) {
    const int st = kt % FSTAGES, k0 = kt * QT;
    if (lane == 0) {
      mbar_expect_tx(&full[st], 2 * T96);
      tma_tile96(sm + L::K + st * T96, tm_k, &full[st], col, k0, elem);
      tma_tile96(sm + L::V + st * T96, tm_v, &full[st], col, k0, elem);
    }
    for (int j = lane; j < QT; j += 32)
      ids[st * QT + j] = k0 + j < S ? mask[row0 + k0 + j] : nan;
    mbar_arrive(&full[st]);
  };
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(resident, 4 * T96);
#pragma unroll
      for (int h = 0; h < 4; ++h)
        tma_tile96(sm + L::Q + h * T96, tm_q, resident, col, q0 + h * QT,
                   elem);
    }
    for (int kt = 0; kt < FSTAGES && kt < n_kt; ++kt) fill(kt);
  }
  const int ra = cw * 64 + ((ct >> 5) & 3) * 16 + g;  // block rows ra, +8
  const int qa = q0 + ra, qb = qa + 8;
  // the Philox row this lane draws: row lane / 2 of the warp's 16
  const int drow = prow0 + q0 + (ra - g) + (lane >> 1);
  // a query past S matches no key (NaN); its output is never stored
  const float qma = qa < S ? mask[row0 + qa] : nan;
  const float qmb = qb < S ? mask[row0 + qb] : nan;
  const float sc2 = sm_scale * LOG2E, ik = drop.inv_keep;
  const unsigned base = smem_addr(sm), a_q = base + L::Q + cw * T96;
  mbar_wait(resident, 0);

  float acc[32], acc1[16];  // o columns 0-63, 64-95
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc1[i] = 0.f;
  // the running row maxima (log2 units) and this thread's share of the
  // row sums
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    // the slot tile kt - 2 held takes tile kt + 2 once every warp is done
    // with it (rarely a wait: two tiles have passed since)
    if (loader && kt >= 2 && kt + 2 < n_kt) {
      mbar_wait(&empty[(kt - 2) % FSTAGES], ((kt - 2) / FSTAGES) & 1);
      fill(kt + 2);
    }
    const int st = kt % FSTAGES;
    const unsigned a_k = base + L::K + st * T96, a_qo = opaque(a_q);
    mbar_wait(&full[st], (kt / FSTAGES) & 1);
    float s[32];
    wgmma_fence();
    issue_nt96(s, a_qo, a_k);
    wgmma_commit();
    // the keep bits while the product runs
    const KeepQ<DROP> keep(
        DROP ? draw_rows(drop, drow, kt * QT + 4 * (lane & 1)) : 0u, lane);
    const float* kid = ids + st * QT + 2 * t4;
    wgmma_wait<0>();
    fence_acc(s);
    unsigned pa[16];
    const float2 alpha = softmax_tile<DROP>(s, pa, kid, qma, qmb,
                                            S - kt * QT, sc2, ik, keep, t4,
                                            ma, mb, la, lb);
    scale_rows(acc, alpha);
    scale_rows(acc1, alpha);
    fence_acc(acc);
    fence_acc(acc1);
    wgmma_fence();
    issue_rs96(acc, acc1, pa, a_k + (L::V - L::K));  // O += drop(P) V
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_acc(acc1);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  const float2 inv = finish_rows(ma, mb, la, lb, lse + prow0, qa, S, t4);
  scale_rows(acc, inv);
  scale_rows(acc1, inv);
  if (qa < S) store96(o, (row0 + qa) * H, col, t4, false, acc, acc1);
  if (qb < S) store96(o, (row0 + qb) * H, col, t4, true, acc, acc1);
}

// launches of the wgmma + TMA kernels, at d = 64 and 96
long long wgmma_launches[2] = {0, 0};

template <bool DROP>
int launch_wgmma(const void* q, const void* k, const void* v, int ld,
                 const float* mask, void* o, float* lse, int B, int S,
                 int n_heads, float sm_scale, const DropParams& drop,
                 cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, FwdSmem::BYTES);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  CUtensorMap tq, tk, tv;
  int rc = rows_map(&tq, q, ld, n_heads, S, B);
  if (rc == 0) rc = rows_map(&tk, k, ld, n_heads, S, B);
  if (rc == 0) rc = rows_map(&tv, v, ld, n_heads, S, B);
  if (rc != 0) return rc;
  dim3 grid((S + FBLOCK - 1) / FBLOCK, n_heads, B);
  flash_fwd_wgmma_kernel<DROP><<<grid, FTHREADS, FwdSmem::BYTES, stream>>>(
      tq, tk, tv, mask, static_cast<bf16*>(o), lse, S, sm_scale, drop);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++wgmma_launches[0];
  return (int)e;
}


template <bool DROP>
int launch_wgmma96(const void* q, const void* k, const void* v, int ld,
                   const float* mask, void* o, float* lse, int B, int S,
                   int n_heads, float sm_scale, const DropParams& drop,
                   cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd96_wgmma_kernel<DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Fwd96Smem::BYTES);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  PanelMaps tq, tk, tv;
  int rc = panel_maps(&tq, q, ld, n_heads, S, B);
  if (rc == 0) rc = panel_maps(&tk, k, ld, n_heads, S, B);
  if (rc == 0) rc = panel_maps(&tv, v, ld, n_heads, S, B);
  if (rc != 0) return rc;
  dim3 grid((S + FBLOCK - 1) / FBLOCK, n_heads, B);
  flash_fwd96_wgmma_kernel<DROP><<<grid, FTHREADS, Fwd96Smem::BYTES, stream>>>(
      tq, tk, tv, mask, static_cast<bf16*>(o), lse, S, sm_scale, drop);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++wgmma_launches[1];
  return (int)e;
}

}  // namespace

extern "C" {

// q, k, v: (B*S, ld) bf16 row-major, each operand's (n_heads * d) columns
// starting at its pointer (16-byte aligned, ld % 8 == 0: at d = 64 and
// 96 TMA reads them; any alignment at the chunked head dims); mask (B, S)
// f32 segment ids -> o (B*S, n_heads * d) bf16 and lse (B, n_heads, S)
// f32.  Any d >= 1, any S >= 1.  Prob dropout when drop_on (philox.cuh).
int nbk_flash_fwd(const void* q, const void* k, const void* v, int ld,
                  const float* mask, void* o, float* lse, int B, int S,
                  int n_heads, int d, float sm_scale,
                  unsigned long long seed, int stream, unsigned thresh,
                  float inv_keep, int drop_on, void* cuda_stream) {
  if (chunked_head_dim(d))
    return nbk_chunked_fwd(q, k, v, ld, mask, o, lse, nullptr, 1, B, S,
                           n_heads, d, sm_scale, seed, stream, thresh,
                           inv_keep, drop_on, cuda_stream);
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const DropParams drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  if (d == WD)
    return drop.on ? launch_wgmma<true>(q, k, v, ld, mask, o, lse, B, S,
                                        n_heads, sm_scale, drop, s)
                   : launch_wgmma<false>(q, k, v, ld, mask, o, lse, B, S,
                                         n_heads, sm_scale, drop, s);
  if (d == 96)
    return drop.on ? launch_wgmma96<true>(q, k, v, ld, mask, o, lse, B, S,
                                          n_heads, sm_scale, drop, s)
                   : launch_wgmma96<false>(q, k, v, ld, mask, o, lse, B, S,
                                           n_heads, sm_scale, drop, s);
#define NBK_FLASH_FWD(D)                                                  \
  case D:                                                                 \
    return launch<D>(q, k, v, ld, mask, o, lse, B, S, n_heads, d,         \
                     sm_scale, drop, s);
  switch (instance_width(d)) {
    NBK_FLASH_FWD(32)
    NBK_FLASH_FWD(64)
    NBK_FLASH_FWD(96)
    NBK_FLASH_FWD(128)
    NBK_FLASH_FWD(192)
    NBK_FLASH_FWD(256)
  }
#undef NBK_FLASH_FWD
  return (int)cudaErrorInvalidValue;
}

// Launches of the wgmma + TMA kernels since the library was loaded, at
// head dim d (64 or 96; 0: both; any other d: 0) -- a routing check: they
// run exactly at d = 64 and 96.
long long nbk_flash_fwd_wgmma_launches(int d) {
  return d == WD   ? wgmma_launches[0]
         : d == 96 ? wgmma_launches[1]
         : d == 0  ? wgmma_launches[0] + wgmma_launches[1]
                   : 0;
}

}  // extern "C"
