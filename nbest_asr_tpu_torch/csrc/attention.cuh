// Device pieces shared by the attention kernels (seg_attention.cu,
// seg_attention_bwd.cu, flash_attention.cu, flash_attention_bwd.cu):
// 64-row q / k / v tiles read by row stride and column offset (from the
// (n, 3h) QKV buffer, or from (b, s, heads, d) tensors), the scores of a
// 64-key tile, the 16-column chunk products of the mma.sync fragments,
// the Philox keep-bit tables of the stream-3 prob dropout (which the
// wgmma kernels draw too), and the pieces the wgmma forward and backward
// share at head dims 64, 96 and 192: swizzled tile copies, the score products,
// the score mask, div_row (the division of a prob by its row's sum) and
// the launch's tiles per block.
//
// Chunk products (g = lane / 4, t = lane % 4, as in common.cuh): a warp
// owns 16 rows of the left operand; a chunk c[j][e], j in {0, 1}, is the
// C fragment of the 16 x 16 product's columns 8 j .. 8 j + 7, element
// (row g + 8 (e >= 2), column 8 j + 2 t + (e & 1)).
//
// Keep-bit tables: the prob dropout of element (query q, key k) of one
// (batch element, head) is Philox word (k & 3) of counter (k >> 2, row0 +
// q, 3, 0) (ops/philox.py).  A block draws the bits of the (rows x 32
// words) slab it needs once, one Philox call per four keys, into shared
// memory, and every pass reads them from there in whatever fragment
// layout it has -- so the forward, the dQ kernel and the dK/dV kernel
// (which holds keys as rows) regenerate the same mask bit for bit.
#pragma once

#include <math.h>

#include "common.cuh"
#include "philox.cuh"
#include "wgmma.cuh"

namespace nbk {
namespace attn {

constexpr int ROWS = 64;      // rows of a q, k, v or dO tile
constexpr int THREADS = 128;  // 4 warps, 16 rows each
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

template <int D>
struct Tile {
  static constexpr int LD = D + 8;  // padded rows: ldmatrix conflict-free
  static constexpr int ELEMS = ROWS * LD;
};

// The mma.sync instance a head dim d runs on: the narrowest of 32, 64,
// 96, 128, 192 and 256 at least d wide; 0 where d is refused (d > 256, or
// d % 8 != 0: the head's columns would leave the 16-byte boundaries the
// tile copies need).  A head narrower than its instance has its columns
// past d zero-filled on load (load_tile) and never stored: zero columns
// of q and k add nothing to a score, zero columns of v and dO nothing to
// an output, dP or di, and the gradient columns past d are not written.
__host__ __device__ constexpr int instance_width(int d) {
  return d <= 0 || d % 8 || d > 256 ? 0
         : d <= 32                  ? 32
         : d <= 64                  ? 64
         : d <= 96                  ? 96
         : d <= 128                 ? 128
         : d <= 192                 ? 192
                                    : 256;
}

// rows [r0, r0 + 64) of one head's dh columns (src points at row 0, column
// head * dh of a row-major matrix with leading dimension ld) -> shared
// tile of D columns; rows past S and columns past dh (dh <= D, dh % 8 ==
// 0) are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S, int ld, int dh) {
  constexpr int CPR = D / 8;
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int row = r0 + r;
    const bool ok = row < S && col < dh;
    cp_async_16(dst + r * Tile<D>::LD + col,
                src + (ok ? (size_t)row * ld + col : 0), ok);
  }
}

// Scaled, masked scores of a warp's 16 query rows (A fragments qf)
// against the 64 keys k0 .. k0 + 63 in the shared tile sK; sMt[j] is the
// segment id of key k0 + j, qma / qmb those of the thread's rows (NaN for
// a row past S: it matches no key).  sc[nt] is the C fragment of keys
// k0 + 8 nt .. + 7: MASK_VALUE where the segments differ, -inf past S.
template <int D>
__device__ __forceinline__ void tile_scores(float (&sc)[8][4],
                                            const unsigned (&qf)[D / 16][4],
                                            const bf16* sK, const float* sMt,
                                            int k0, int S, float qma,
                                            float qmb, float sm_scale,
                                            int lane) {
  constexpr int LD = Tile<D>::LD;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[nt][c] = 0.f;
  // dot_nt16's products with the d-chunk loop outermost (fewer live
  // registers); each score still accumulates over d in order, so the
  // bits equal dot_nt16's
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
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
      const int j = nt * 8 + 2 * t4 + (c & 1);
      const float qm = c < 2 ? qma : qmb;
      const float v = sc[nt][c] * sm_scale;
      sc[nt][c] = k0 + j >= S ? -INFINITY : (sMt[j] == qm ? v : MASK_VALUE);
    }
  }
}

// A fragments of 16 rows (x points at the first) of a shared tile.
template <int D>
__device__ __forceinline__ void load_a(unsigned (&af)[D / 16][4],
                                       const bf16* x, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(af[kk], x + (lane & 15) * Tile<D>::LD + kk * 16 +
                            (lane >> 4) * 8);
}

// c = A (16 x D) . X^T for X the 16 rows at x of a (rows, D) shared
// tile: the 16 x 16 chunk of, e.g., the scores of 16 queries against 16
// keys.  Accumulates over D in order, so equal inputs give equal bits.
template <int D>
__device__ __forceinline__ void dot_nt16(float (*c)[4],
                                         const unsigned (&af)[D / 16][4],
                                         const bf16* x, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // X is (n, d) row-major = B^T: plain 8x8 loads give B fragments;
    // matrices = (n 0-7, d 0-7), (n 0-7, d 8-15), (n 8-15, d 0-7),
    // (n 8-15, d 8-15)
    unsigned f[4];
    const int r = (lane & 7) + ((lane >> 4) << 3);
    const int col = kk * 16 + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(f, x + r * Tile<D>::LD + col);
    mma_bf16(c[0], af[kk], f[0], f[1]);
    mma_bf16(c[1], af[kk], f[2], f[3]);
  }
}

// acc (16 x D) += bf16(P) (16 x 16, a chunk) . X for X the 16 rows at x
// of a (rows, D) shared tile: the C fragments of P are the A fragment of
// the next product, rounded to bf16 on the way.
template <int D>
__device__ __forceinline__ void mma_chunk(float (&acc)[D / 8][4],
                                          float (*p)[4],
                                          const bf16* x, int lane) {
  unsigned pa[4];
  pa[0] = pack_bf16x2(p[0][0], p[0][1]);
  pa[1] = pack_bf16x2(p[0][2], p[0][3]);
  pa[2] = pack_bf16x2(p[1][0], p[1][1]);
  pa[3] = pack_bf16x2(p[1][2], p[1][3]);
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    // X is (k, d) row-major = B: transposed 8x8 loads; matrices =
    // (k 0-7, d 0-7), (k 8-15, d 0-7), (k 0-7, d 8-15), (k 8-15, d 8-15)
    unsigned f[4];
    const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int col = dp * 16 + (lane >> 4) * 8;
    ldmatrix_x4_trans(f, x + r * Tile<D>::LD + col);
    mma_bf16(acc[2 * dp], pa, f[0], f[1]);
    mma_bf16(acc[2 * dp + 1], pa, f[2], f[3]);
  }
}

// Keep bits of rows row0 .. row0 + rows - 1 (Philox rows of the prob
// mask), key columns col0 .. col0 + 32 words - 1, into tab[r * stride +
// w] (bit b of word w = key col0 + 32 w + b).  Threads tid of nthreads
// (by default all of the block's) take part; the caller synchronises
// before reading.
__device__ __forceinline__ void build_keep(unsigned* tab, int rows, int words,
                                           int stride, const DropParams& d,
                                           int row0, int col0, int tid,
                                           int nthreads) {
  for (int i = tid; i < rows * words; i += nthreads) {
    const int r = i / words, w = i % words;
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 v = philox_group(d, row0 + r, col0 + w * 32 + j * 4);
      bits |= (unsigned)(v.x >= d.thresh) << (4 * j);
      bits |= (unsigned)(v.y >= d.thresh) << (4 * j + 1);
      bits |= (unsigned)(v.z >= d.thresh) << (4 * j + 2);
      bits |= (unsigned)(v.w >= d.thresh) << (4 * j + 3);
    }
    tab[r * stride + w] = bits;
  }
}

__device__ __forceinline__ void build_keep(unsigned* tab, int rows, int words,
                                           int stride, const DropParams& d,
                                           int row0, int col0) {
  build_keep(tab, rows, words, stride, d, row0, col0, threadIdx.x, THREADS);
}

// Keep bit of table row r, key column c (c below the table's 32 * words).
__device__ __forceinline__ bool kept(const unsigned* tab, int stride, int r,
                                     int c) {
  return (tab[r * stride + (c >> 5)] >> (c & 31)) & 1u;
}

// Words per row of a forward / dQ table over S keys; odd, so that the 8
// rows a fragment column reads fall in 8 banks.
__host__ __device__ __forceinline__ int keep_stride(int S) {
  return ((S + 31) / 32) | 1;
}

// -------------------------------------------------------------------- //
// The wgmma kernels' pieces (head dims 64, 96 and 192; seg_attention.cu's
// forward and seg_attention_bwd.cu's backward issue the same score
// products, so the backward rebuilds the forward's scores bit for bit)
// -------------------------------------------------------------------- //

constexpr int WD = 64;             // the 128-byte panel's columns
constexpr int QT = 64;             // query rows of a warpgroup's tile
constexpr int QTILE = QT * WD * 2;  // bytes of a swizzled 64 x 64 tile

// A tile of R rows of a head's D columns (D = 64, 96 or 192) lies in
// shared memory as panels: columns 0-63 128-byte-swizzled (R * 128 bytes),
// then at D = 96 columns 64-95 64-byte-swizzled (R * 64 bytes), at D = 192
// columns 64-127 and 128-191 as two more 128-byte-swizzled panels (a
// 384-byte row is three whole swizzle atoms).  A 96-column
// row is 192 bytes, which no one swizzle mode spans; a second 128-byte
// panel with 32 zero columns would take a third more shared memory (K
// and V at S = 256: 128 KB against 96 KB, which would leave no room for
// the second consumer warpgroup's Q tiles), while the 64-byte panel costs
// one more descriptor mode and an m64n32 product beside each m64n64.

// The d = 192 pair past 256 keys (seg_attention.cu's forward and
// seg_attention_bwd.cu's dq kernel) streams K and V a 64-row tile (three
// 128-byte-swizzled panels) at a time; the forward's keep table and the
// dq kernel's, which rebuilds the forward's bits, share one row stride.
struct Long192 {
  static constexpr int MAXK = 512;            // keys a row holds at most
  static constexpr int TB = QT * 192 * 2;     // bytes of a 64-row tile
  static constexpr int KSTRIDE = MAXK / 32 | 1;
};

// p, made opaque to the compiler: the wgmma descriptors built from it
// are computed where they are used instead of once for a whole tile loop
// or for two sweeps, where dozens of them held in registers beside a
// thread's probs would spill.
__device__ __forceinline__ const unsigned char* fresh(
    const unsigned char* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// rows r0 .. r0 + rows - 1 of one head's D columns (src: row 0, column
// head * D of a row-major matrix with row stride ld) -> the tile's panels
// at dst (rows rows); rows past S are zero-filled.  Threads tid of
// nthreads.
template <int D = WD>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const bf16* src,
                                          int ld, int r0, int rows, int S,
                                          int tid, int nthreads) {
  for (int c = tid; c < rows * 8; c += nthreads) {
    const int r = c >> 3, ch = c & 7, row = r0 + r;
    const bool ok = row < S;
    cp_async_16(dst + swizzle128(r, ch),
                src + (size_t)(ok ? row : 0) * ld + ch * 8, ok);
  }
  if constexpr (D == 96) {
    unsigned char* dst1 = dst + rows * 128;
    for (int c = tid; c < rows * 4; c += nthreads) {
      const int r = c >> 2, ch = c & 3, row = r0 + r;
      const bool ok = row < S;
      cp_async_16(dst1 + swizzle64(r, ch),
                  src + (size_t)(ok ? row : 0) * ld + WD + ch * 8, ok);
    }
  }
  if constexpr (D == 192) {  // panels 1 and 2: 16 more chunks a row
    for (int c = tid; c < rows * 16; c += nthreads) {
      const int r = c >> 4, p = 1 + ((c >> 3) & 1), ch = c & 7;
      const int row = r0 + r;
      const bool ok = row < S;
      cp_async_16(dst + p * rows * 128 + swizzle128(r, ch),
                  src + (size_t)(ok ? row : 0) * ld + p * WD + ch * 8, ok);
    }
  }
}

// Issues (and commits) the scores of the warpgroup's 64 queries (sQt, a
// 64-row tile) against the NK keys of the window at sKw (panel 0; sKw1
// its panel 1 at D = 96; at D = 192 the keys' panels lie kpanel bytes
// apart): thread fragment sc[4 jj + e] = (row 16 warp + g + 8 (e >= 2),
// key 8 jj + 2 t + (e & 1)).  Per 64-key chunk (and a 32-key tail) the
// k16 steps run in column order, 4 on panel 0 then 2 on panel 1 (D = 96)
// or 4 on panel 1 and 4 on panel 2 (D = 192).  seg_attention_bwd.cu
// issues its S and dP products through it too (W = 64 or 32 keys at a
// time, or a warpgroup's share of a window), so each 64-key chunk's
// scores are the forward's bit for bit.
template <int NK, int D = WD>
__device__ __forceinline__ void issue_scores(
    float (&sc)[NK / 2], const unsigned char* sQt, const unsigned char* sKw,
    const unsigned char* sKw1 = nullptr, int kpanel = 0) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WD / 16; ++kk) {
    // a k16 step is 32 bytes along the swizzled 128-byte rows; 8-row
    // groups 1024 bytes apart; a 64-key chunk of K is 8192 bytes
    const uint64_t da = smem_desc(sQt + kk * 32, 1, 64);
#pragma unroll
    for (int c = 0; c < NK / 64; ++c)
      wgmma_ss_n64(sc + 32 * c, da, smem_desc(sKw + c * 8192 + kk * 32, 1,
                                              64), kk);
    if (NK % 64)
      wgmma_ss_n32(sc + 32 * (NK / 64), da,
                   smem_desc(sKw + (NK / 64) * 8192 + kk * 32, 1, 64), kk);
  }
  if constexpr (D == 96) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      // 64-byte rows: 8-row groups 512 bytes apart, a 64-key chunk 4096
      const uint64_t da = smem_desc64(sQt + QT * 128 + kk * 32, 1, 32);
#pragma unroll
      for (int c = 0; c < NK / 64; ++c)
        wgmma_ss_n64(sc + 32 * c, da,
                     smem_desc64(sKw1 + c * 4096 + kk * 32, 1, 32), 1);
      if (NK % 64)
        wgmma_ss_n32(sc + 32 * (NK / 64), da,
                     smem_desc64(sKw1 + (NK / 64) * 4096 + kk * 32, 1, 32),
                     1);
    }
  }
  if constexpr (D == 192) {
#pragma unroll
    for (int p = 1; p < 3; ++p) {
#pragma unroll
      for (int kk = 0; kk < WD / 16; ++kk) {
        const uint64_t da = smem_desc(sQt + p * QT * 128 + kk * 32, 1, 64);
        const unsigned char* kp = sKw + p * kpanel + kk * 32;
#pragma unroll
        for (int c = 0; c < NK / 64; ++c)
          wgmma_ss_n64(sc + 32 * c, da, smem_desc(kp + c * 8192, 1, 64), 1);
        if (NK % 64)
          wgmma_ss_n32(sc + 32 * (NK / 64), da,
                       smem_desc(kp + (NK / 64) * 8192, 1, 64), 1);
      }
    }
  }
  wgmma_commit();
}

// Scaled, masked scores (MASK_VALUE where the segments differ; sMw: the
// window's key segment ids, NaN past S) and the row maxima ma, mb.
template <int NK>
__device__ __forceinline__ void mask_scores(float (&sc)[NK / 2],
                                            const float* sMw, float qma,
                                            float qmb, float sm_scale, int t4,
                                            float& ma, float& mb) {
#pragma unroll
  for (int jj = 0; jj < NK / 8; ++jj) {
    const float2 km =
        *reinterpret_cast<const float2*>(sMw + jj * 8 + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = sc[4 * jj + e] * sm_scale;
      const float s = ((e & 1) ? km.y : km.x) == (e < 2 ? qma : qmb)
                          ? v
                          : MASK_VALUE;
      sc[4 * jj + e] = s;
      if (e < 2)
        ma = fmaxf(ma, s);
      else
        mb = fmaxf(mb, s);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// x / l rounded to nearest for a row's sum l >= 1 and rl = __frcp_rn(l):
// Markstein's correction of x * rl, which is the IEEE quotient bit for bit
// wherever the FMA's remainder
// is exact, x >= 2^-90; a smaller x is scaled by 2^64 first, so only a
// subnormal quotient (p < 2^-126) may round twice, by one subnormal ulp.
// Branch-free: the IEEE division branches to its slow path at every prob,
// which cut the unrolled softmax into 128 blocks, 4x slower at seq 256 on
// the H100 (PERF.md).
__device__ __forceinline__ float div_row(float x, float l, float rl) {
  const bool tiny = x < 0x1p-90f;
  const float xs = tiny ? x * 0x1p64f : x;
  const float q = __fmul_rn(xs, rl);
  const float p = __fmaf_rn(__fmaf_rn(-q, l, xs), rl, q);
  return tiny ? p * 0x1p-64f : p;
}

// Query tiles a block takes (its consumer warpgroups nwg share the head's
// K and V): the largest count whose estimated time -- full waves of
// blocks over the SMs' slots, times a block's tiles on one warpgroup plus
// one more for its K / V copy -- is least.  Against one tile a block and
// all of a head's tiles, it picked the fastest or within 1% at 64 x {64,
// 96, 160, 256}, 32 x 256 and 16 x 512 at d = 64 (PERF.md).
inline int tiles_per_block(int n_qt, int heads, int slots, int nwg) {
  int best = n_qt;
  double best_t = 1e300;
  for (int tpb = n_qt; tpb >= 1; --tpb) {
    const long long blocks = (long long)heads * ((n_qt + tpb - 1) / tpb);
    const double waves = (double)((blocks + slots - 1) / slots);
    const double t = waves * ((tpb + nwg - 1) / nwg + 1);
    if (t < best_t) best_t = t, best = tpb;
  }
  return best;
}

}  // namespace attn
}  // namespace nbk
