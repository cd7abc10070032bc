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
//   chunked_fwd     the single-block forward (_sb_fwd_kernel: probs
//                   normalised, then dropped and rounded to bf16; each
//                   row's max and sum of exp written) or the tiled one
//                   (_fwd_kernel: an online softmax, exp(s - m) dropped
//                   and rounded, o scaled by 1 / l; lse = m + log(l))
//   chunked_bwd_dq  dq, and di: rowsum(dp * p) over the keys (single-
//                   block) or rowsum(dO * O) in its prologue (tiled)
//   chunked_bwd_dkv dk and dv, from di
// with the arithmetic of the plain versions (kernels.py:
// sb_attention_reference, flash_fwd_reference, ...).
//
// Scores: a score accumulates over the head's columns in one fixed order
// of mma.sync k16 steps (chunk_scores; the forward's panel_scores issues
// the same products), in every kernel and every pass -- the dK/dV kernel
// issues them with the keys as rows -- so the forward's probs and the
// backward's rebuilt ones are the same bits.  k16 steps wholly past d are
// skipped; the columns of the last one past d are zero.
//
// chunked_fwd (section 1) is built for the H100: a block owns 64 query
// rows and keeps the accumulators of a slab of output columns in
// registers as wgmma accumulators, NC panels of 64 columns a warpgroup
// (32 at ceil16(d) <= 32), so its scores are built once per key tile
// for all of the slab's columns: once in all on the tiled contract, and
// on the single-block one once more before, for the statistics (each
// prob is normalised, dropped and rounded before P . V, as _sb_fwd_kernel
// does).  One warpgroup takes d <= 192; two take d <= 384, each scoring
// half of a tile's keys and both multiplying the whole tile's P, which
// meets in shared memory with the rows' maxima and sums; a wider head is
// taken a 384-column slab at a time.  P . V runs on wgmma: A is P from
// registers (one warpgroup) or shared memory (two), B a 64-key panel of V
// read MN-major.  Q stays in shared memory for the block's life up to d
// = 384 (48 KB); past that its panels stream beside K's.  K, V (and a
// streamed Q) arrive as 64-row swizzled panels by cp.async through a
// ring of 4 slots (3 at one warpgroup and one panel), 3 (2) steps ahead
// of the products, a tile's key segment ids with its last score step's
// panels; each warp draws its rows' Philox keep bits once per key tile,
// in registers, as the flash kernels do.  A panel copies ceil16(d)
// columns at most, so d = 12 copies 16 of a 32-column panel.
//
// The backward pair (sections 2, 3) takes the head dim in 64-column
// chunks, so registers and shared memory do not grow with d: a block
// holds one 64-row tile of each operand's current chunk (cp.async, rows
// past S and columns past d zero-filled), a warp 16 rows, and per 64-key
// tile a thread keeps 32 score and 32 dP accumulators and 32 output
// accumulators of one 64-column output chunk, recomputing the scores for
// each output chunk (about ceil(d / 64) + 1 score products against the
// function's one).
//
// What bounds chunked_fwd on the H100: 4 b h s^2 d tensor-core operations
// against 8 b s h bytes; at d = 384 and s = 256 the bytes.  The kernel
// stays far from that bound (PERF.md, section 6): on the single-block
// contract it builds the scores twice, on mma.sync, and at 2 heads of 384
// a block's first thread spends about 30% of its clocks issuing copies
// and 26% in the score products; at d = 12 the exponentials and the
// Philox keep bits take over half.
//
// Any alignment: a head's first column is d * head elements into a row,
// so at d % 8 != 0 it leaves the 16-byte boundaries; the copies go at the
// widest width (16, 8, 4 or 2 bytes) that every operand's address, row
// stride and d allow (the launch computes it), and the stores write two
// bf16 at a time where the address allows, else one.  No TMA: a tensor
// map needs 16-byte aligned rows.
//
// The prob dropout is Philox stream 3 at row (elem * n_heads + head) * S
// + q, column k (the backward pair: attention.cuh's build_keep, per 64 x
// 64 tile into shared memory; the forward: draw_keys, a warp's rows in
// registers), the mask every other attention instance draws.  Each
// pass over queries and keys is ordered: a block owns its query (or key)
// rows and writes each output once, so there are no atomics.
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "attention_chunked.cuh"
#include "flash_wgmma.cuh"

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
// 1. chunked_fwd: 64 query rows a block, its output slab in wgmma
//    accumulators
// ---------------------------------------------------------------------- //

constexpr float LN2 = 0.6931471805599453f;

// Byte of 16-byte chunk c of row r in a swizzled panel of PW columns: 64
// columns (128-byte swizzle) or 32 (64-byte swizzle), as wgmma reads it.
template <int PW>
__device__ __forceinline__ int swz(int r, int c) {
  return PW == 64 ? swizzle128(r, c) : swizzle64(r, c);
}

// d (64 x 64) (+)= A (64 x 16, K-major, shared) * B (16 x 64, MN-major,
// shared, transpose-B): P from shared memory times a panel of V.
__device__ __forceinline__ void wgmma_st_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// sc += the 16 query rows from r0 of the shared Q panel qp (A operand)
// against the keys kw0 .. kw0 + 8 NT - 1 of the shared K panel kp: the
// first nkk k16 steps of the panel (the rest are columns past d), in
// column order -- chunk_scores' products, on swizzled panels.
template <int PW, int NT>
__device__ __forceinline__ void panel_scores(float (&sc)[NT][4],
                                             const unsigned char* qp,
                                             const unsigned char* kp, int r0,
                                             int kw0, int nkk, int lane) {
#pragma unroll
  for (int kk = 0; kk < PW / 16; ++kk) {
    if (kk >= nkk) break;
    unsigned af[4];
    ldmatrix_x4(af, qp + swz<PW>(r0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned kf[4];
      const int r = kw0 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(kf, kp + swz<PW>(r, 2 * kk + ((lane >> 3) & 1)));
      mma_bf16(sc[2 * np], af, kf[0], kf[1]);
      mma_bf16(sc[2 * np + 1], af, kf[2], kf[3]);
    }
  }
}

// Keep bits of one query row against 8 NT keys from col (a multiple of 4),
// drawn by lanes 2 r + h of a warp for its row r: keys 8 jj + 4 h .. + 3
// of the warpgroup's, bit 4 jj + i = key col + 8 jj + i
// (flash_wgmma.cuh's draw_rows at NT = 8; KeepQ hands the bits out).
template <int NT>
__device__ __forceinline__ unsigned draw_keys(const DropParams& d, int row,
                                              int col) {
  unsigned w = 0;
#pragma unroll
  for (int jj = 0; jj < NT; ++jj) {
    const uint4 v = philox_group(d, row, col + 8 * jj);
    w |= (unsigned)(v.x >= d.thresh) << (4 * jj) |
         (unsigned)(v.y >= d.thresh) << (4 * jj + 1) |
         (unsigned)(v.z >= d.thresh) << (4 * jj + 2) |
         (unsigned)(v.w >= d.thresh) << (4 * jj + 3);
  }
  return w;
}

// The instances: NWG warpgroups a block, panels of PW columns, NC panels
// a warpgroup (a slab of NWG NC panels), Q resident or streamed.
//   0 <1, 32, 1, resident>   ceil16(d) <= 32
//   1 <1, 64, 1, resident>   ceil16(d) <= 64
//   2 <1, 64, 2, resident>   ceil16(d) <= 128
//   3 <1, 64, 3, resident>   ceil16(d) <= 192
//   4 <2, 64, 3, resident>   ceil16(d) <= 384
//   5 <2, 64, 3, streamed>   wider: the block takes its slabs in turn
constexpr int FWD_INSTANCES = 6;
long long fwd_instance_launches[FWD_INSTANCES] = {0, 0, 0, 0, 0, 0};

int fwd_instance(int d) {
  const int d16 = (d + 15) / 16 * 16;
  return d16 <= 32 ? 0 : d16 <= 64 ? 1 : d16 <= 128 ? 2 : d16 <= 192 ? 3
         : d16 <= 384                               ? 4
                                                    : 5;
}

// Shared memory, offsets from a 1024-byte-aligned base: the resident Q
// panels, the ring's slots (each: NWG panels of K or of V, and at a
// streamed Q its NWG panels of Q beside K's), the bf16 P tile (two
// warpgroups), each slot's key segment ids, and the warpgroups' row
// maxima and sums.
template <int NWG, int PW, int NC, bool QRES>
struct FwdShape {
  static constexpr int THREADS = 128 * NWG;
  static constexpr int PB = ROWS * PW * 2;   // bytes of a 64-row panel
  static constexpr int KEYS = ROWS / NWG;    // a warpgroup's keys of a tile
  static constexpr int NT = KEYS / 8;        // their 8-key fragment columns
  static constexpr int ACC = PW / 2;         // accumulators a thread a panel
  static constexpr int SLAB = NWG * NC;      // panels of a slab
  // one warpgroup and one panel: a tile's K and V panels share a slot
  static constexpr bool MERGED = NWG == 1 && NC == 1;
  // ring slots: the copies run DEPTH - 1 steps ahead
  static constexpr int DEPTH = MERGED ? 3 : 4;
  static constexpr int SLOT = NWG * PB * (QRES && !MERGED ? 1 : 2);
  static constexpr int Q = 0;
  static constexpr int RING = Q + (QRES ? SLAB * PB : 0);
  static constexpr int P = RING + DEPTH * SLOT;
  static constexpr int IDS = P + (NWG == 2 ? ROWS * ROWS * 2 : 0);
  static constexpr int XCH = IDS + DEPTH * ROWS * 4;
  static constexpr int BYTES = 1024 + XCH + 2 * NWG * ROWS * 4;
};
static_assert(FwdShape<2, 64, 3, false>::BYTES <= 232448, "shared memory");

// TILED: o = (drop(exp(s - m)) rounded) V / l and st0 = lse = m + log(l),
// m and l the online softmax's running max and sum; else o = drop(p =
// exp(s - m) / l) rounded . V with m and l from a first sweep, and st0 /
// st1 (if not null) = each row's m and l.
//
// One loop over the block's steps, so that each piece of code is issued
// from one place.  A step is one wait for the ring (cp.async groups, DEPTH
// - 2 in flight) and one block barrier.  A key tile is nks score steps
// (NWG panels of K each, Q's too where it streams) and, after the first
// sweep, NC V steps (panel j of each warpgroup's slab); at one warpgroup
// and one panel the tile's V panel rides in its score step.  The copies
// of step t + DEPTH - 1 are issued at step t, into the slot step t - 1
// freed.  Warpgroup w scores keys KEYS w .. of each tile on mma.sync in
// chunk_scores' order, and multiplies P (all 64 keys) by its NC panels of
// V on wgmma: from registers at one warpgroup, from the shared P tile at
// two, whose row maxima and sums meet in shared memory.
template <int NWG, int PW, int NC, bool QRES, bool DROP, bool TILED>
__global__ void __launch_bounds__(128 * NWG)
    chunked_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, int ld,
                       const float* __restrict__ mask, bf16* __restrict__ out,
                       float* __restrict__ st0, float* __restrict__ st1,
                       int S, int dh, int lv, float sm_scale,
                       DropParams drop) {
  using L = FwdShape<NWG, PW, NC, QRES>;
  constexpr int NT = L::NT, PB = L::PB;
  constexpr bool MERGED = L::MERGED;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* ids = reinterpret_cast<float*>(sm + L::IDS);
  float* xmax = reinterpret_cast<float*>(sm + L::XCH);
  float* xsum = xmax + NWG * ROWS;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * ROWS;
  const Head hd = head_of(q, k, v, ld, mask, S, dh);
  const int H = gridDim.y * dh;
  const int r0 = ((tid >> 5) & 3) * 16;  // the warp's 16 query rows
  const int ra = r0 + g, qa = q0 + ra, qb = qa + 8;
  const int kw0 = wg * L::KEYS;          // the warpgroup's keys of a tile
  const float nan = __int_as_float(0x7fc00000);
  const float qma = qa < S ? hd.mrow[qa] : nan;
  const float qmb = qb < S ? hd.mrow[qb] : nan;
  const int n_kt = (S + ROWS - 1) / ROWS, d16 = (dh + 15) & ~15;
  const int n_pan = (d16 + PW - 1) / PW, nks = (n_pan + NWG - 1) / NWG;
  const int n_slab = (n_pan + L::SLAB - 1) / L::SLAB;
  const int vsteps = MERGED ? 0 : NC;  // V steps a tile after the first sweep
  const int n_steps =
      (TILED ? 0 : n_kt * nks) + n_slab * n_kt * (nks + vsteps);

  // a thread's copies of a panel: 2^lv elements at column cc of rows rr0,
  // rr0 + rstep, ... (the same in every panel); a row's copies span the
  // panel, or at one panel the head's ceil16(d) columns rounded up to a
  // power of two, so that few threads sit idle at a narrow head
  const int span = n_pan > 1 ? PW : d16 <= 16 ? 16 : d16 <= 32 ? 32 : 64;
  const int cshift = __ffs(span) - 1 - lv;  // log2 of the copies a row
  const int cc = (tid & ((1 << cshift) - 1)) << lv;
  const int rr0 = tid >> cshift, rstep = L::THREADS >> cshift;
  // rows r .. r + 63 of panel pan of src (one head's row 0, column 0) ->
  // dst, and at TWO the same of src2 -> dst2; rows past S and columns past
  // dh zero-filled, columns past ceil16(dh) not copied
  auto copy_panel = [&](auto two, unsigned char* dst, const bf16* src,
                        unsigned char* dst2, const bf16* src2, int r,
                        int pan) {
    const int hc = pan * PW + cc;
    if (hc >= d16) return;
    const bool cok = hc < dh;
    for (int rr = rr0; rr < ROWS; rr += rstep) {
      const int row = r + rr;
      const bool ok = cok && row < S;
      const size_t off = ok ? (size_t)row * ld + hc : 0;
      const int so = swz<PW>(rr, cc >> 3) + (cc & 7) * 2;
#pragma unroll
      for (int c = 0; c < (decltype(two)::value ? 2 : 1); ++c) {
        const bf16* gp = (c ? src2 : src) + off;
        unsigned char* sp = (c ? dst2 : dst) + so;
        if (lv == 3)
          cp_async_16(sp, gp, ok);
        else if (lv == 2)
          cp_async_8(sp, gp, ok);
        else if (lv == 1)
          cp_async_4(sp, gp, ok);
        else
          *reinterpret_cast<bf16*>(sp) = ok ? *gp : __float2bfloat16_rn(0.f);
      }
    }
  };
  constexpr std::false_type one{};
  constexpr std::true_type two{};
  // the next step's copies into its slot (one commit group, empty past
  // the end): a score step's K panels (and Q's, streamed; at MERGED the
  // tile's V panel after the first sweep) and, at a tile's last, its key
  // segment ids (0 past S); a V step's V panels
  // the step the next fill copies: its index, key tile, place in the tile
  // and slab (-1: the first sweep)
  int fu = 0, fkt = 0, fi = 0, fslab = TILED ? 0 : -1;
  auto fill = [&]() {
    if (fu < n_steps) {
      const int st = fu % L::DEPTH, slab = fslab, i = fi, k0 = fkt * ROWS;
      unsigned char* slot = sm + L::RING + st * L::SLOT;
      if (++fi == (fslab < 0 ? nks : nks + vsteps)) {
        fi = 0;
        if (++fkt == n_kt) {
          fkt = 0;
          ++fslab;
        }
      }
      if (i < nks) {
        if (MERGED && slab >= 0)  // the tile's K and V panels
          copy_panel(two, slot, hd.k, slot + PB, hd.v, k0, 0);
        else
          for (int p = 0; p < NWG && NWG * i + p < n_pan; ++p) {
            copy_panel(one, slot + p * PB, hd.k, nullptr, nullptr, k0,
                       NWG * i + p);
            if (!QRES)
              copy_panel(one, slot + (NWG + p) * PB, hd.q, nullptr, nullptr,
                         q0, NWG * i + p);
          }
        if (i == nks - 1 && tid < ROWS)
          cp_async_4(ids + st * ROWS + tid,
                     hd.mrow + (k0 + tid < S ? k0 + tid : 0), k0 + tid < S);
      } else {
        for (int p = 0; p < NWG; ++p) {
          const int pan = slab * L::SLAB + p * NC + (i - nks);
          if (pan < n_pan)
            copy_panel(one, slot + p * PB, hd.v, nullptr, nullptr, k0, pan);
        }
      }
    }
    ++fu;
    cp_async_commit();
  };

  if constexpr (QRES)
    for (int pan = 0; pan < n_pan; ++pan)
      copy_panel(one, sm + L::Q + pan * PB, hd.q, nullptr, nullptr, q0, pan);
  for (int u = 0; u < L::DEPTH - 1; ++u) fill();

  // scaled by scale, MASK_VALUE where the segments differ, -inf for keys
  // past S (the tile's first nk keys lie below S)
  auto mask_scores = [&](float (&sc)[NT][4], const float* id, int nk,
                         float scale) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 km =
          *reinterpret_cast<const float2*>(id + kw0 + nt * 8 + 2 * t4);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sc[nt][c] = ((c & 1) ? km.y : km.x) == (c < 2 ? qma : qmb)
                        ? sc[nt][c] * scale
                        : MASK_VALUE;
    }
    if (nk < ROWS) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (kw0 + nt * 8 + 2 * t4 + (c & 1) >= nk) sc[nt][c] = -INFINITY;
    }
  };
  // the rows' maxima over the tile's 64 keys
  auto tile_max = [&](const float (&sc)[NT][4], float& ta, float& tb) {
    ta = -INFINITY;
    tb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      ta = fmaxf(ta, fmaxf(sc[nt][0], sc[nt][1]));
      tb = fmaxf(tb, fmaxf(sc[nt][2], sc[nt][3]));
    }
    ta = quad_max(ta);
    tb = quad_max(tb);
    if constexpr (NWG == 2) {
      if (t4 == 0) {
        xmax[wg * ROWS + ra] = ta;
        xmax[wg * ROWS + ra + 8] = tb;
      }
      __syncthreads();
      ta = fmaxf(ta, xmax[(wg ^ 1) * ROWS + ra]);
      tb = fmaxf(tb, xmax[(wg ^ 1) * ROWS + ra + 8]);
    }
  };
  // a thread's share of the rows' sums -> the sums
  auto row_sum = [&](float& la, float& lb) {
    la = quad_sum(la);
    lb = quad_sum(lb);
    if constexpr (NWG == 2) {
      if (t4 == 0) {
        xsum[wg * ROWS + ra] = la;
        xsum[wg * ROWS + ra + 8] = lb;
      }
      __syncthreads();
      la += xsum[(wg ^ 1) * ROWS + ra];
      lb += xsum[(wg ^ 1) * ROWS + ra + 8];
    }
  };
  // a fragment column's probs, rounded to bf16: the A operand of P V
  unsigned pa[NWG == 1 ? 16 : 1];
  auto put_p = [&](int nt, const float (&x)[4]) {
    if constexpr (NWG == 1) {
      pa[2 * nt] = pack_bf16x2(x[0], x[1]);
      pa[2 * nt + 1] = pack_bf16x2(x[2], x[3]);
    } else {
      const int key = kw0 + nt * 8 + 2 * t4;
      unsigned char* sp = sm + L::P + (key & 7) * 2;
      *reinterpret_cast<unsigned*>(sp + swizzle128(ra, key >> 3)) =
          pack_bf16x2(x[0], x[1]);
      *reinterpret_cast<unsigned*>(sp + swizzle128(ra + 8, key >> 3)) =
          pack_bf16x2(x[2], x[3]);
    }
  };
  float acc[NC][L::ACC];
  // O += P V for panel j of the warpgroup's slab, V's panel at shared
  // address vb (issued and committed; the caller waits)
  auto issue_pv = [&](int j, unsigned vb) {
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      if (jj != j) continue;
      fence_acc(acc[jj]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (NWG == 2)
          wgmma_st_n64(
              acc[jj],
              flash::desc_at<flash::KMAJOR128>(smem_addr(sm + L::P) +
                                               kk * 32),
              flash::desc_at<flash::MNMAJOR128>(vb + kk * 2048), 1);
        else if constexpr (PW == 64)
          wgmma_rs_n64(acc[jj], pa + 4 * kk,
                       flash::desc_at<flash::MNMAJOR128>(vb + kk * 2048), 1);
        else
          wgmma_rs_n32(acc[jj], pa + 4 * kk,
                       flash::desc_at<flash::PANEL64>(vb + kk * 1024), 1);
      }
      wgmma_commit();
    }
  };
  auto wait_pv = [&]() {
    wgmma_wait<0>();
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) fence_acc(acc[jj]);
  };
#pragma unroll
  for (int jj = 0; jj < NC; ++jj)
#pragma unroll
    for (int e = 0; e < L::ACC; ++e) acc[jj][e] = 0.f;

  float sc[NT][4];
  // the rows' max and sum: of the first sweep (single-block), or running
  // (TILED); at the sweep's end, the sums' reciprocals
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  float rla = 0.f, rlb = 0.f;
  const float sc2 = sm_scale * flash::LOG2E, ik = drop.inv_keep;
  bool first = !TILED;  // in the single-block contract's first sweep
  int slab = 0, kt = 0, i = 0;
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    // step t's copies are in (every thread's, and its earlier shared
    // writes, visible to wgmma too); every thread is past step t - 1, so
    // its slot takes step t + DEPTH - 1
    cp_async_wait<L::DEPTH - 2>();
    fence_proxy_async();
    __syncthreads();
    const unsigned char* slot = sm + L::RING + (t % L::DEPTH) * L::SLOT;
    if (!MERGED && i >= nks) issue_pv(i - nks, smem_addr(slot + wg * PB));
    fill();
    if constexpr (!MERGED) wait_pv();
    if (i < nks) {
      if (i == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[nt][c] = 0.f;
      }
#pragma unroll
      for (int p = 0; p < NWG; ++p) {
        const int pan = NWG * i + p;
        if (pan < n_pan)
          panel_scores<PW, NT>(
              sc, QRES ? sm + L::Q + pan * PB : slot + (NWG + p) * PB,
              slot + p * PB, r0, kw0, min(PW, d16 - pan * PW) / 16, lane);
      }
      if (i == nks - 1) {
        const float* id = ids + (t % L::DEPTH) * ROWS;
        const int nk = S - kt * ROWS;
        if (!TILED && first) {
          // the first sweep: each row's max and sum of exp (the sum
          // rescaled as the max grows)
          mask_scores(sc, id, nk, sm_scale);
          float ta, tb;
          tile_max(sc, ta, tb);
          // the first tile holds key 0, so na and nb are finite
          const float na = fmaxf(ma, ta), nb = fmaxf(mb, tb);
          la *= expf(ma - na);
          lb *= expf(mb - nb);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            la += expf(sc[nt][0] - na) + expf(sc[nt][1] - na);
            lb += expf(sc[nt][2] - nb) + expf(sc[nt][3] - nb);
          }
          ma = na;
          mb = nb;
        } else {
          // the keep bits of the warp's 16 rows against the warpgroup's
          // keys, drawn while the last score products finish
          const flash::KeepQ<DROP> keep(
              DROP ? draw_keys<NT>(drop, hd.prow0 + q0 + r0 + (lane >> 1),
                                   kt * ROWS + kw0 + 4 * (lane & 1))
                   : 0u,
              lane);
          auto dropped = [&](float p, int nt, int c) {
            return !DROP ? p : keep(c >= 2, nt, c & 1) ? __fmul_rn(p, ik)
                                                       : 0.f;
          };
          if constexpr (TILED) {
            // online softmax in log2 units, MASK_VALUE itself the sentinel
            mask_scores(sc, id, nk, sc2);
            float ta, tb;
            tile_max(sc, ta, tb);
            // every tile holds a key below S, so na and nb are finite;
            // the first tile's rescale is 2^-inf = 0
            const float na = fmaxf(ma, ta), nb = fmaxf(mb, tb);
            const float aa = flash::ex2(ma - na), ab = flash::ex2(mb - nb);
            ma = na;
            mb = nb;
            la *= aa;
            lb *= ab;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              float x[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float p = flash::ex2(sc[nt][c] - (c < 2 ? na : nb));
                if (c < 2)
                  la += p;
                else
                  lb += p;
                x[c] = dropped(p, nt, c);
              }
              put_p(nt, x);
            }
#pragma unroll
            for (int jj = 0; jj < NC; ++jj)
#pragma unroll
              for (int e = 0; e < L::ACC; e += 4) {
                acc[jj][e] *= aa;
                acc[jj][e + 1] *= aa;
                acc[jj][e + 2] *= ab;
                acc[jj][e + 3] *= ab;
              }
          } else {
            mask_scores(sc, id, nk, sm_scale);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              float x[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const bool lo = c < 2;
                const float e = expf(sc[nt][c] - (lo ? ma : mb));
                x[c] = dropped(lo ? div_row(e, la, rla) : div_row(e, lb, rlb),
                               nt, c);
              }
              put_p(nt, x);
            }
          }
          if constexpr (MERGED) {
            issue_pv(0, smem_addr(slot + PB));
            wait_pv();
          }
        }
      }
    }

    // on to the next step; a sweep's end
    if (++i < ((!TILED && first) ? nks : nks + vsteps)) continue;
    i = 0;
    if (++kt < n_kt) continue;
    kt = 0;
    if (!TILED && first) {
      first = false;
      row_sum(la, lb);
      if (st0 != nullptr && wg == 0 && t4 == 0) {
        if (qa < S) {
          st0[hd.prow0 + qa] = ma;
          st1[hd.prow0 + qa] = la;
        }
        if (qb < S) {
          st0[hd.prow0 + qb] = mb;
          st1[hd.prow0 + qb] = lb;
        }
      }
      rla = __frcp_rn(la);
      rlb = __frcp_rn(lb);
      continue;
    }
    // the slab's end: its columns out
    float ia = 1.f, ib = 1.f;
    if constexpr (TILED) {
      float sa = la, sb = lb;
      row_sum(sa, sb);
      if (slab == 0 && wg == 0 && t4 == 0) {
        if (qa < S) st0[hd.prow0 + qa] = ma * LN2 + logf(fmaxf(sa, 1e-30f));
        if (qb < S) st0[hd.prow0 + qb] = mb * LN2 + logf(fmaxf(sb, 1e-30f));
      }
      ia = sa == 0.f ? 1.f : 1.f / sa;
      ib = sb == 0.f ? 1.f : 1.f / sb;
      ma = mb = -INFINITY;
      la = lb = 0.f;
    }
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int pan = slab * L::SLAB + wg * NC + jj;
      if (pan < n_pan) {
#pragma unroll
        for (int c8 = 0; c8 < PW / 8; ++c8) {
          const int col = pan * PW + c8 * 8 + 2 * t4;
          if (qa < S)
            store_pair(out + (hd.row0 + qa) * H + blockIdx.y * dh, col,
                       acc[jj][4 * c8] * ia, acc[jj][4 * c8 + 1] * ia, dh);
          if (qb < S)
            store_pair(out + (hd.row0 + qb) * H + blockIdx.y * dh, col,
                       acc[jj][4 * c8 + 2] * ib, acc[jj][4 * c8 + 3] * ib,
                       dh);
        }
      }
#pragma unroll
      for (int e = 0; e < L::ACC; ++e) acc[jj][e] = 0.f;
    }
    ++slab;
  }
}

template <int NWG, int PW, int NC, bool QRES, bool DROP, bool TILED>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, int ld,
               const float* mask, bf16* out, float* st0, float* st1, int B,
               int S, int n_heads, int d, int lv, float sm_scale,
               const DropParams& drop, cudaStream_t s) {
  using L = FwdShape<NWG, PW, NC, QRES>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunked_fwd_kernel<NWG, PW, NC, QRES, DROP, TILED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const dim3 grid((S + ROWS - 1) / ROWS, n_heads, B);
  chunked_fwd_kernel<NWG, PW, NC, QRES, DROP, TILED>
      <<<grid, L::THREADS, L::BYTES, s>>>(q, k, v, ld, mask, out, st0, st1,
                                          S, d, lv, sm_scale, drop);
  return 0;
}

// The instance's four forms: with and without dropout, tiled or not.
template <int NWG, int PW, int NC, bool QRES>
int launch_fwd_forms(bool tiled, const bf16* q, const bf16* k, const bf16* v,
               int ld, const float* mask, bf16* out, float* st0, float* st1,
               int B, int S, int n_heads, int d, int lv, float sm_scale,
               const DropParams& drop, cudaStream_t s) {
#define NBK_CHUNKED_FWD(DROP, TILED)                                       \
  return launch_fwd<NWG, PW, NC, QRES, DROP, TILED>(                       \
      q, k, v, ld, mask, out, st0, st1, B, S, n_heads, d, lv, sm_scale,    \
      drop, s)
  if (drop.on) {
    if (tiled) NBK_CHUNKED_FWD(true, true);
    NBK_CHUNKED_FWD(true, false);
  }
  if (tiled) NBK_CHUNKED_FWD(false, true);
  NBK_CHUNKED_FWD(false, false);
#undef NBK_CHUNKED_FWD
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
  const bf16 *bq = static_cast<const bf16*>(q),
             *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v);
  bf16* bo = static_cast<bf16*>(out);
  const int inst = fwd_instance(d);
#define NBK_CHUNKED_FWD(I, NWG, PW, NC, QRES)                              \
  case I:                                                                  \
    rc = launch_fwd_forms<NWG, PW, NC, QRES>(tiled != 0, bq, bk, bv, ld,   \
                                             mask, bo, st0, st1, B, S,     \
                                             n_heads, d, lv, sm_scale,     \
                                             drop, s);                     \
    break;
  int rc = (int)cudaErrorInvalidValue;
  switch (inst) {
    NBK_CHUNKED_FWD(0, 1, 32, 1, true)
    NBK_CHUNKED_FWD(1, 1, 64, 1, true)
    NBK_CHUNKED_FWD(2, 1, 64, 2, true)
    NBK_CHUNKED_FWD(3, 1, 64, 3, true)
    NBK_CHUNKED_FWD(4, 2, 64, 3, true)
    NBK_CHUNKED_FWD(5, 2, 64, 3, false)
  }
#undef NBK_CHUNKED_FWD
  if (rc != 0) return rc;
  rc = launched(0);
  if (rc == 0) ++fwd_instance_launches[inst];
  return rc;
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

// Launches of chunked_fwd since the library was loaded by instance (0 ..
// 5, fwd_instance: kernels.CHUNKED_FWD_INSTANCES); -1 for any other.
long long nbk_chunked_fwd_instance_launches(int inst) {
  return inst >= 0 && inst < FWD_INSTANCES ? fwd_instance_launches[inst]
                                           : -1;
}

}  // extern "C"
