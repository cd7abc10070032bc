// Tiled flash-attention backward: dq, dk, dv from q, k, v, the forward's
// o and lse (flash_attention.cu), the output gradient dO and the segment
// mask, for any sequence length.
//
// Replaces nbest_asr_tpu/ops/flash_attention.py:_bwd_dq_kernel (:276) and
// _bwd_dkv_kernel (:226), with the row pass di = rowsum(dO * O) (f32) of
// _flash_core_bwd (:499).  Both rebuild the probs from lse and compute
//   p    = exp(s - lse)                 (undropped, f32)
//   dp   = drop(dO v^T)                 (the forward's stream-3 mask)
//   p_v  = drop(p);   dv = bf16(p_v)^T dO
//   ds   = bf16(p * (dp - di) * sm_scale);   dq = ds k,   dk = ds^T q
// As in the TPU kernels the sums run in two kernels with no atomics, so
// the result does not depend on block scheduling:
//   1. the dQ kernel, per (element, head, block of queries), keys innermost:
//      its prologue computes di for its rows from the O and dO tiles and
//      stores it for kernel 2;
//   2. the dK/dV kernel, per (element, head, block of keys), queries
//      innermost: keys are the warps' rows, so S^T = K Q^T and dP^T = V
//      dO^T come out as C fragments that are directly the A fragments of
//      dV += P_v^T dO and dK += dS^T Q.
// q, k, v are read by row stride as the forward reads them, dO and O are
// (b, s, heads, d), dq, dk, dv are written with their own row stride:
// no transposes, no padding.  The keep bits are drawn from their Philox
// counters (attention.cuh) as each kernel's tiles need them, so both
// kernels regenerate the forward's mask whatever their loop order.
//
// Three pairs here and the chunked family; nbk_flash_bwd_dq /
// nbk_flash_bwd_dkv pick by head dim:
//   d = 64 (any S)        the wgmma + TMA pair (section 3)
//   d = 96 (any S)        its twin on 96-column rows (section 4)
//   every other d <= 256  the mma.sync pair (sections 1 and 2), on its
//   with d % 8 == 0       instance of width 32, 64, 96, 128, 192 or 256
//                         (attention.cuh, instance_width: a d between two
//                         widths runs on the wider, its columns past d
//                         zero-filled on load and never stored; d = 40 ..
//                         56 on the 64-wide pair, 72 .. 88 on the 96-wide
//                         one, which run only such padded heads)
//   d > 256, d % 8 != 0   chunked_bwd_dq / chunked_bwd_dkv
//                         (attention_chunked.cu), at any alignment
// Neither falls back to the other: a pair that does not build or launch
// makes the call fail.
//
// The mma.sync pair: the single-block backward's (seg_attention_bwd.cu)
// 16-column chunk products, with tile-local segment ids, statistics and
// keep bits so that shared memory does not grow with S.  Each warp owns 16
// rows of a 64-row block and reads the whole streamed tile through ldmatrix
// for each product; every tile is copied, waited for and its keep bits drawn
// into a shared table before its math.  The dK/dV kernel holds its keys'
// K and V fragments and both accumulators in registers, 3 d / 2 a thread:
// at d = 192 and 256 more than a thread has, so those instances spill
// (ptxas's report; a correct first version, not yet a fast one).
//
// The wgmma + TMA pair at d = 64: a block owns 128 rows (queries in the dQ
// kernel, keys in the dK/dV kernel) as two consumer warpgroups of 64 rows,
// plus a producer warpgroup that gives its registers to them (setmaxnreg).
// The producer's first thread loads the block's resident tiles (Q, dO, O;
// or K, V) once and then streams the other side's 64-row tiles (K, V; or
// Q, dO) by TMA (3-D maps: head column, row, batch element, so rows past S
// are zero-filled within each element) into a ring of STAGES slots with
// full / empty mbarriers; its threads write each slot's segment ids (and
// the dK/dV kernel's lse and di).  The consumers issue S and dP on wgmma
// from shared memory (m64n64k16, K-major, descriptors built once) and,
// while the products run, draw the tile's Philox keep bits: each warp the
// bits of its own 16 rows, 8 calls a lane, handed to the lanes that use
// them by shuffles.  They rebuild p = exp2(s log2e - lse log2e) in
// registers and pack ds (and the dropped p) into bf16 A fragments, which
// multiply the slot's tiles read MN-major (dQ += dS K; dV += P_v^T dO, dK
// += dS^T Q): nothing goes back through shared memory.
//
// What bounds it on the H100 (chip_time_attention.py, PERF.md): the
// tensor cores would take 0.16 ms (dQ, 3 products) and 0.21 ms (dK/dV, 4)
// at route B's 32 x 1024 x 12 heads.  Without dropout the pair runs at
// 0.41 and 0.48 ms: per tile a warpgroup waits on its score products,
// then runs some 350 dependent instructions of masking, exp2 and ds at
// low IPC, then waits on its last product.  With dropout each kernel adds
// one Philox call per four (query, key) pairs, 2,048 per 128 x 64 tile,
// whose 32 x 32 -> 64-bit multiplies (IMAD.WIDE, some 18 a call) take the
// integer pipe about 1,900 cycles a tile: that, not the tensor cores, sets
// the pace.  A producer warpgroup drawing the bits (one warp per scheduler)
// ran 1.2x slower; turns between the consumer warpgroups, or the draws
// placed beside the elementwise work, gained nothing.
//
// The d = 96 pair (section 4) is the same design on 96-column tiles (two
// swizzled panels, the pieces flash_wgmma.cuh shares with the d = 96
// forward, flash_attention.cu section 3); at
// the quality encoder's 32 x 1024 x 8 heads it runs at 0.61 / 0.82 ms
// (0.37 / 0.57 without dropout) against the tensor cores' 0.16 / 0.21
// (PERF.md): per (query, key) pair the same elementwise and Philox work
// as at d = 64, on half as many again products.  Its dK/dV kernel needs
// 230 registers a thread, more than a 384-thread block leaves, so it
// runs two warpgroups and fills its ring from warp 0; the dQ kernel
// fits 168 and keeps the producer warpgroup (filled from warp 0 it ran
// 16% slower).
#include "attention_chunked.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace nbk;
using namespace nbk::attn;
using namespace nbk::flash;

constexpr int KWORDS = 2;   // keep words per row of a 64 x 64 tile
constexpr int KSTRIDE = 3;  // odd: a fragment column's 8 rows, 8 banks

template <int D>
size_t dq_smem() {
  return (size_t)5 * Tile<D>::ELEMS * sizeof(bf16) +   // Q, dO, K, V, O
         (size_t)2 * ROWS * sizeof(float) +             // key ids, di
         (size_t)ROWS * KSTRIDE * sizeof(unsigned);
}

template <int D>
size_t dkv_smem() {
  return (size_t)4 * Tile<D>::ELEMS * sizeof(bf16) +   // K, V, Q, dO
         (size_t)3 * ROWS * sizeof(float) +             // query ids, lse, di
         (size_t)ROWS * KSTRIDE * sizeof(unsigned);
}

// -------------------------------------------------------------------- //
// 1. dq (and di), per 64-query tile, keys innermost
// -------------------------------------------------------------------- //

// Blocks per SM: 4 at d = 32 and 64 (128 registers), 2 at d = 96, 1 at d
// >= 128.  The head is dh <= D columns wide (columns past dh are zeros in
// the tiles); o and dout have rows of n_heads * dh.
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : D == 96 ? 2 : 1)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, int ld,
                    const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    const float* __restrict__ mask,
                    const float* __restrict__ lse, float* __restrict__ di,
                    bf16* __restrict__ dq, int ld_g, int S, int dh,
                    float sm_scale, DropParams drop) {
  constexpr int LD = Tile<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + Tile<D>::ELEMS;  // dO
  bf16* sK = sO + Tile<D>::ELEMS;
  bf16* sV = sK + Tile<D>::ELEMS;
  bf16* sOut = sV + Tile<D>::ELEMS;  // the forward's o
  float* sMk = reinterpret_cast<float*>(sOut + Tile<D>::ELEMS);
  float* sDi = sMk + ROWS;
  unsigned* sKeep = reinterpret_cast<unsigned*>(sDi + ROWS);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * ROWS, head = blockIdx.y, elem = blockIdx.z;
  const int n_heads = gridDim.y;
  const int H = n_heads * dh;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;
  const size_t off = row0 * ld + head * dh;
  const size_t off_h = row0 * H + head * dh;
  const bf16* k_src = k + off;
  const bf16* v_src = v + off;
  const float* mrow = mask + row0;

  load_tile<D>(sQ, q + off, q0, S, ld, dh);
  load_tile<D>(sO, dout + off_h, q0, S, H, dh);
  load_tile<D>(sOut, o + off_h, q0, S, H, dh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // di = rowsum(f32(dO) * f32(O)): two threads a row, half the columns
  // each (rows past S are zero-filled, so their di is 0)
  {
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
    float sum = 0.f;
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c)
      sum = __fadd_rn(sum, __fmul_rn(__bfloat162float(sO[r * LD + c0 + c]),
                                     __bfloat162float(sOut[r * LD + c0 + c])));
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((threadIdx.x & 1) == 0) {
      sDi[r] = sum;
      if (q0 + r < S) di[prow0 + q0 + r] = sum;
    }
  }

  unsigned qf[D / 16][4], of[D / 16][4];
  load_a<D>(qf, sQ + warp * 16 * LD, lane);
  load_a<D>(of, sO + warp * 16 * LD, lane);

  const int g = lane >> 2, t4 = lane & 3;
  const int ra = warp * 16 + g;
  const int qa = q0 + ra, qb = qa + 8;
  const float nan = __int_as_float(0x7fc00000);
  const float qma = qa < S ? mrow[qa] : nan, qmb = qb < S ? mrow[qb] : nan;
  // rows past S: lse = 0 turns their MASK_VALUE scores into p = 0
  const float lsa = qa < S ? lse[prow0 + qa] : 0.f;
  const float lsb = qb < S ? lse[prow0 + qb] : 0.f;
  __syncthreads();
  const float dia = sDi[ra], dib = sDi[ra + 8];
  const int n_kt = (S + ROWS - 1) / ROWS;

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * ROWS;
    __syncthreads();
    load_tile<D>(sK, k_src, k0, S, ld, dh);
    load_tile<D>(sV, v_src, k0, S, ld, dh);
    cp_async_commit();
    for (int j = threadIdx.x; j < ROWS; j += THREADS)
      sMk[j] = k0 + j < S ? mrow[k0 + j] : 0.f;
    if (DROP) build_keep(sKeep, ROWS, KWORDS, KSTRIDE, drop, prow0 + q0, k0);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float sc[2][4], dp[2][4];
      dot_nt16<D>(sc, qf, sK + ks * 16 * LD, lane);
      dot_nt16<D>(dp, of, sV + ks * 16 * LD, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = ks * 16 + j * 8 + 2 * t4 + (e & 1);
          const bool lo = e < 2;
          const float sv = sc[j][e] * sm_scale;
          const float s = k0 + kl >= S
                              ? -INFINITY
                              : (sMk[kl] == (lo ? qma : qmb) ? sv : MASK_VALUE);
          const float p = expf(s - (lo ? lsa : lsb));
          float d = dp[j][e];
          if (DROP)
            d = kept(sKeep, KSTRIDE, ra + (e >> 1) * 8, kl)
                    ? __fmul_rn(d, drop.inv_keep)
                    : 0.f;
          sc[j][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(d, lo ? dia : dib)),
                               sm_scale);
        }
      }
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

// Blocks per SM: 4 at d = 32 and 64 (128 registers), 2 at d = 96 (the K
// and V fragments and both accumulators take 144 registers), 1 at d >=
// 128 (192 registers at d = 128).
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : D == 96 ? 2 : 1)
    flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, int ld,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ mask,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dk_out,
                     bf16* __restrict__ dv_out, int ld_g, int S, int dh,
                     float sm_scale, DropParams drop) {
  constexpr int LD = Tile<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + Tile<D>::ELEMS;
  bf16* sQ = sV + Tile<D>::ELEMS;
  bf16* sO = sQ + Tile<D>::ELEMS;  // dO
  float* sSt = reinterpret_cast<float*>(sO + Tile<D>::ELEMS);
  unsigned* sKeep = reinterpret_cast<unsigned*>(sSt + 3 * ROWS);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * ROWS, head = blockIdx.y, elem = blockIdx.z;
  const int n_heads = gridDim.y;
  const int H = n_heads * dh;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;
  const size_t off = row0 * ld + head * dh;
  const bf16* q_src = q + off;
  const bf16* o_src = dout + row0 * H + head * dh;
  const float* mrow = mask + row0;

  load_tile<D>(sK, k + off, k0, S, ld, dh);
  load_tile<D>(sV, v + off, k0, S, ld, dh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  unsigned kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, sK + warp * 16 * LD, lane);
  load_a<D>(vf, sV + warp * 16 * LD, lane);

  const int g = lane >> 2, t4 = lane & 3;
  const int kla = warp * 16 + g;  // this thread's keys, relative to k0
  const int ka = k0 + kla, kb = ka + 8;
  const float kma = ka < S ? mrow[ka] : 0.f, kmb = kb < S ? mrow[kb] : 0.f;

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
      sSt[j] = ok ? mrow[qr] : 0.f;                  // segment id
      sSt[ROWS + j] = ok ? lse[prow0 + qr] : 0.f;
      sSt[2 * ROWS + j] = ok ? di[prow0 + qr] : 0.f;
    }
    // keep bits of this tile's 64 query rows against the block's 64 keys
    if (DROP) build_keep(sKeep, ROWS, KWORDS, KSTRIDE, drop, prow0 + qt0, k0);
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
          const bool lo = e < 2;
          const int kr = lo ? ka : kb;
          const float sv = st[j][e] * sm_scale;
          const float s = (qt0 + ql >= S || kr >= S)
                              ? -INFINITY
                              : (sSt[ql] == (lo ? kma : kmb) ? sv : MASK_VALUE);
          const float p = expf(s - sSt[ROWS + ql]);
          float pd = p, d = dpt[j][e];
          if (DROP) {
            const bool keep = kept(sKeep, KSTRIDE, ql, kr - k0);
            pd = keep ? __fmul_rn(p, drop.inv_keep) : 0.f;
            d = keep ? __fmul_rn(d, drop.inv_keep) : 0.f;
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

// -------------------------------------------------------------------- //
// 3. The wgmma + TMA pair, d = 64 (any S)
// -------------------------------------------------------------------- //

constexpr int BLOCK = 128;     // rows a block owns: two consumer warpgroups
constexpr int WTHREADS = 384;  // the producer warpgroup, then the consumers
constexpr int STAGES = 3;      // ring slots of streamed 64-row tiles
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 = 63 K
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// Barrier of the two consumer warpgroups (named barrier 1).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// sum + a . b over the eight bf16 pairs of two 16-byte chunks, in order,
// each product and sum rounded (the mma.sync kernel's di).
__device__ __forceinline__ float dot8(float sum, uint4 a, uint4 b) {
  const unsigned x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sum = __fadd_rn(sum, __fmul_rn(__uint_as_float(x[i] << 16),
                                   __uint_as_float(y[i] << 16)));
    sum = __fadd_rn(sum, __fmul_rn(__uint_as_float(x[i] & 0xffff0000u),
                                   __uint_as_float(y[i] & 0xffff0000u)));
  }
  return sum;
}

// Keep bits of the dK/dV kernel, which holds keys as rows (flash_wgmma.cuh
// draws query rows): lane 8 c + 2 t + h draws keys 4 c .. + 3 of
// the warp (col = the first's key) against queries 8 jj + 2 t + e, jj = 4
// h .. + 3 of the tile (row = the Philox row of query 2 t + 32 h): byte i,
// bit 2 (jj % 4) + e = key 4 c + i.
template <int ROUND = 4>
__device__ __forceinline__ unsigned draw_keys(const DropParams& d, int row,
                                              int col) {
  unsigned w = 0;
  // rounds of ROUND calls: at d = 64 two rounds of four (eight in flight
  // beside the in-flight scores and the dK, dV sums spill), at d = 96
  // four of two
#pragma unroll 1
  for (int jh = 0; jh < 8; jh += ROUND)
#pragma unroll
    for (int i = 0; i < ROUND; ++i) {
      const int b = jh + i;
      const uint4 v = philox_group(d, row + 8 * (b >> 1) + (b & 1), col);
      w |= (unsigned)(v.x >= d.thresh) << b |
           (unsigned)(v.y >= d.thresh) << (8 + b) |
           (unsigned)(v.z >= d.thresh) << (16 + b) |
           (unsigned)(v.w >= d.thresh) << (24 + b);
    }
  return w;
}

// The keys g and g + 8 of a dK/dV thread (16 query bits each, its columns
// of jj < 4 and jj >= 4), from the lanes that drew them.
template <bool DROP>
struct KeepKV {
  unsigned a0 = 0, a1 = 0, b0 = 0, b1 = 0;
  __device__ __forceinline__ KeepKV(unsigned w, int lane) {
    if (!DROP) return;
    const int g = lane >> 2, t4 = lane & 3, sh = 8 * (g & 3);
    const int la = 8 * (g >> 2) + 2 * t4;  // key group g / 4, this t
    a0 = __shfl_sync(0xffffffffu, w, la) >> sh;
    a1 = __shfl_sync(0xffffffffu, w, la + 1) >> sh;
    b0 = __shfl_sync(0xffffffffu, w, la + 16) >> sh;  // key group + 2
    b1 = __shfl_sync(0xffffffffu, w, la + 17) >> sh;
  }
  __device__ __forceinline__ bool operator()(bool hi, int jj, int e) const {
    const unsigned w = hi ? (jj < 4 ? b0 : b1) : (jj < 4 ? a0 : a1);
    return (w >> (2 * (jj & 3) + e)) & 1u;
  }
};

// The dQ kernel's shared memory, offsets from a 1024-byte-aligned base: Q,
// dO and O of the block's 128 queries (two 64-row boxes each), the ring's
// K and V tiles, each slot's key segment ids (NaN past S), di of the 128
// queries, the barriers (full and empty per slot, one for Q, dO, O).
struct DqSmem {
  static constexpr int Q = 0, DO = Q + 2 * QTILE, O = DO + 2 * QTILE;
  static constexpr int K = O + 2 * QTILE, V = K + STAGES * QTILE;
  static constexpr int IDS = V + STAGES * QTILE;
  static constexpr int DI = IDS + STAGES * QT * 4;
  static constexpr int BAR = DI + BLOCK * 4;
  static constexpr int BYTES = 1024 + BAR + (2 * STAGES + 1) * 8;
};

// The dK/dV kernel's: K and V of the block's 128 keys, the ring's Q and dO
// tiles, each slot's query segment ids (NaN past S), per query pair (2 m, 2
// m + 1) a float4 {lse log2e of 2 m, of 2 m + 1, di of 2 m, of 2 m + 1} (0
// past S), the barriers.
struct DkvSmem {
  static constexpr int K = 0, V = K + 2 * QTILE;
  static constexpr int Q = V + 2 * QTILE, DO = Q + STAGES * QTILE;
  static constexpr int IDS = DO + STAGES * QTILE;
  static constexpr int STAT = IDS + STAGES * QT * 4;
  static constexpr int BAR = STAT + STAGES * QT * 2 * 4;
  static constexpr int BYTES = 1024 + BAR + (2 * STAGES + 1) * 8;
};
static_assert(DqSmem::BYTES <= 232448 && DkvSmem::BYTES <= 232448,
              "shared memory");

// Issues (and commits) a = A . B^T and b = C . D^T, 64 x 64 each, from
// K-major tiles with descriptors da .. dd (m64n64k16, four k-steps).
__device__ __forceinline__ void issue_two(float (&a)[32], float (&b)[32],
                                          uint64_t da, uint64_t db,
                                          uint64_t dc, uint64_t dd) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64(a, da + kk * KSTEP, db + kk * KSTEP, kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64(b, dc + kk * KSTEP, dd + kk * KSTEP, kk);
  wgmma_commit();
}

// The dQ kernel: per (element, head, 128 queries), keys innermost.
// Consumer warpgroup w owns queries 64 w .. + 63 of the block.
template <bool DROP>
__global__ void __launch_bounds__(WTHREADS, 1) flash_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o,
    const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ mask, const float* __restrict__ lse,
    float* __restrict__ di, bf16* __restrict__ dq, int ld_g, int S,
    float sm_scale, DropParams drop) {
  using L = DqSmem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* ids = reinterpret_cast<float*>(sm + L::IDS);
  float* sdi = reinterpret_cast<float*>(sm + L::DI);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  const int head = blockIdx.y, elem = blockIdx.z, col = head * WD;
  const int q0 = blockIdx.x * BLOCK;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * gridDim.y + head) * S;  // Philox row of query 0
  const int n_kt = (S + QT - 1) / QT;
  const float nan = __int_as_float(0x7fc00000);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 129);  // the TMA bytes + the 128 producer threads
      mbar_init(&empty[s], 8);   // one arrive per consumer warp
    }
    mbar_init(resident, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: the resident tiles once, then each key tile's K, V and
    // segment ids, up to STAGES tiles ahead of the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    const int tid = threadIdx.x;
    if (tid == 0) {
      mbar_expect_tx(resident, 6 * QTILE);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tma_load(sm + L::Q + h * QTILE, &tm_q, resident, col, q0 + h * QT,
                 elem);
        tma_load(sm + L::DO + h * QTILE, &tm_do, resident, col,
                 q0 + h * QT, elem);
        tma_load(sm + L::O + h * QTILE, &tm_o, resident, col, q0 + h * QT,
                 elem);
      }
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % STAGES, k0 = kt * QT;
      mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
      if (tid == 0) {
        mbar_expect_tx(&full[st], 2 * QTILE);
        tma_load(sm + L::K + st * QTILE, &tm_k, &full[st], col, k0, elem);
        tma_load(sm + L::V + st * QTILE, &tm_v, &full[st], col, k0, elem);
      }
      if (tid < QT)
        ids[st * QT + tid] = k0 + tid < S ? mask[row0 + k0 + tid] : nan;
      mbar_arrive(&full[st]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int ct = threadIdx.x - 128, cw = ct >> 7;
  const int lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  mbar_wait(resident, 0);
  {  // di = rowsum(f32(dO) * f32(O)): two threads a row, 32 columns each
    const int r = ct >> 1, c0 = (ct & 1) * 4;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      sum = dot8(sum,
                 *reinterpret_cast<const uint4*>(sm + L::DO +
                                                 swizzle128(r, c0 + c)),
                 *reinterpret_cast<const uint4*>(sm + L::O +
                                                 swizzle128(r, c0 + c)));
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((ct & 1) == 0) {
      sdi[r] = sum;
      if (q0 + r < S) di[prow0 + q0 + r] = sum;
    }
  }
  consumer_sync();

  const int ra = cw * 64 + ((ct >> 5) & 3) * 16 + g;  // block rows ra, +8
  const int qa = q0 + ra, qb = qa + 8;
  // the Philox row this lane draws: row lane / 2 of the warp's 16
  const int drow = prow0 + q0 + (ra - g) + (lane >> 1);
  // a query past S matches no key (NaN), so its p is 0 whatever its lse
  const float qma = qa < S ? mask[row0 + qa] : nan;
  const float qmb = qb < S ? mask[row0 + qb] : nan;
  // p sm_scale = 2^(s sm_scale log2e - (lse log2e - log2 sm_scale))
  const float l2s = log2f(sm_scale);
  const float la = (qa < S ? lse[prow0 + qa] * LOG2E : 0.f) - l2s;
  const float lb = (qb < S ? lse[prow0 + qb] * LOG2E : 0.f) - l2s;
  const float dia = sdi[ra], dib = sdi[ra + 8];
  const float sc2 = sm_scale * LOG2E, ik = drop.inv_keep;
  const uint64_t d_q = kmajor(sm + L::Q + cw * QTILE);
  const uint64_t d_do = kmajor(sm + L::DO + cw * QTILE);
  const uint64_t d_k = kmajor(sm + L::K), d_v = kmajor(sm + L::V);
  const uint64_t d_kt = mnmajor(sm + L::K);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % STAGES;
    const uint64_t slot = st * TILE_DESC;
    mbar_wait(&full[st], (kt / STAGES) & 1);
    float s[32], dp[32];
    issue_two(s, dp, d_q, d_k + slot, d_do, d_v + slot);
    // the keep bits while the products run
    const KeepQ<DROP> keep(
        DROP ? draw_rows(drop, drow, kt * QT + 4 * (lane & 1)) : 0u, lane);
    const float* kid = ids + st * QT + 2 * t4;
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    // ds = bf16(p (drop(dp) - di) sm_scale), packed as A fragments
    unsigned pa[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 km = *reinterpret_cast<const float2*>(kid + 8 * jj);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        const bool lo = e < 2;
        const float d_i = lo ? dia : dib;
        const float x = ((e & 1) ? km.y : km.x) == (lo ? qma : qmb)
                            ? fmaf(s[i], sc2, -(lo ? la : lb))
                            : -INFINITY;
        // drop(dp) - di: dp * (keep ? inv_keep : 0) - di
        const float dm =
            DROP ? fmaf(dp[i], keep(!lo, jj, e & 1) ? ik : 0.f, -d_i)
                 : dp[i] - d_i;
        v[e] = ex2(x) * dm;
      }
      pa[2 * jj] = pack_bf16x2(v[0], v[1]);
      pa[2 * jj + 1] = pack_bf16x2(v[2], v[3]);
    }
    fence_acc(acc);
    wgmma_fence();
    issue_rs(acc, pa, d_kt + slot);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = col + jj * 8 + 2 * t4;
    if (qa < S)
      *reinterpret_cast<unsigned*>(dq + (row0 + qa) * ld_g + c) =
          pack_bf16x2(acc[4 * jj], acc[4 * jj + 1]);
    if (qb < S)
      *reinterpret_cast<unsigned*>(dq + (row0 + qb) * ld_g + c) =
          pack_bf16x2(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

// The dK/dV kernel: per (element, head, 128 keys), queries innermost.
// Consumer warpgroup w owns keys 64 w .. + 63 of the block: S^T = K Q^T and
// dP^T = V dO^T have the keys as rows, so their C fragments are the A
// fragments of dV += P_v^T dO and dK += dS^T Q.
template <bool DROP>
__global__ void __launch_bounds__(WTHREADS, 1) flash_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ mask, const float* __restrict__ lse,
    const float* __restrict__ di, bf16* __restrict__ dk_out,
    bf16* __restrict__ dv_out, int ld_g, int S, float sm_scale,
    DropParams drop) {
  using L = DkvSmem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* ids = reinterpret_cast<float*>(sm + L::IDS);
  float* stat = reinterpret_cast<float*>(sm + L::STAT);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = empty + STAGES;

  const int head = blockIdx.y, elem = blockIdx.z, col = head * WD;
  const int k0 = blockIdx.x * BLOCK;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * gridDim.y + head) * S;  // Philox row of query 0
  const int n_qt = (S + QT - 1) / QT;
  const float nan = __int_as_float(0x7fc00000);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 129);  // the TMA bytes + the 128 producer threads
      mbar_init(&empty[s], 8);   // one arrive per consumer warp
    }
    mbar_init(resident, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: K and V once, then each query tile's Q, dO, segment ids,
    // lse and di, up to STAGES tiles ahead of the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    const int tid = threadIdx.x;
    if (tid == 0) {
      mbar_expect_tx(resident, 4 * QTILE);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tma_load(sm + L::K + h * QTILE, &tm_k, resident, col, k0 + h * QT,
                 elem);
        tma_load(sm + L::V + h * QTILE, &tm_v, resident, col, k0 + h * QT,
                 elem);
      }
    }
    for (int qt = 0; qt < n_qt; ++qt) {
      const int st = qt % STAGES, q0 = qt * QT;
      mbar_wait(&empty[st], ((qt / STAGES) & 1) ^ 1);
      if (tid == 0) {
        mbar_expect_tx(&full[st], 2 * QTILE);
        tma_load(sm + L::Q + st * QTILE, &tm_q, &full[st], col, q0, elem);
        tma_load(sm + L::DO + st * QTILE, &tm_do, &full[st], col, q0, elem);
      }
      if (tid < QT) {
        const int q = q0 + tid;
        const bool ok = q < S;
        ids[st * QT + tid] = ok ? mask[row0 + q] : nan;
        float* p = stat + st * QT * 2 + (tid >> 1) * 4 + (tid & 1);
        p[0] = ok ? lse[prow0 + q] * LOG2E : 0.f;
        p[2] = ok ? di[prow0 + q] : 0.f;
      }
      mbar_arrive(&full[st]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int ct = threadIdx.x - 128, cw = ct >> 7;
  const int lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = cw * 64 + ((ct >> 5) & 3) * 16 + g;  // block keys ra, +8
  const int ka = k0 + ra, kb = ka + 8;
  // the keys and the Philox row of the first query this lane draws
  const int dcol = k0 + (ra - g) + 4 * (lane >> 3);
  const int drow = prow0 + 2 * ((lane >> 1) & 3) + 32 * (lane & 1);
  // a key past S matches no query (NaN), so its p is 0
  const float kma = ka < S ? mask[row0 + ka] : nan;
  const float kmb = kb < S ? mask[row0 + kb] : nan;
  const float sc2 = sm_scale * LOG2E, ik = drop.inv_keep;
  const uint64_t d_k = kmajor(sm + L::K + cw * QTILE);
  const uint64_t d_v = kmajor(sm + L::V + cw * QTILE);
  const uint64_t d_q = kmajor(sm + L::Q), d_do = kmajor(sm + L::DO);
  const uint64_t d_qt = mnmajor(sm + L::Q), d_dot = mnmajor(sm + L::DO);
  mbar_wait(resident, 0);

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int st = qt % STAGES;
    const uint64_t slot = st * TILE_DESC;
    mbar_wait(&full[st], (qt / STAGES) & 1);
    float s[32], dp[32];  // S^T, dP^T: rows keys, columns queries
    issue_two(s, dp, d_k, d_q + slot, d_v, d_do + slot);
    // the keep bits while the products run
    const KeepKV<DROP> keep(
        DROP ? draw_keys(drop, drow + qt * QT, dcol) : 0u, lane);
    const float* qid = ids + st * QT + 2 * t4;
    const float4* cst = reinterpret_cast<const float4*>(stat + st * QT * 2) +
                        t4;
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    // p_v = bf16(drop(p)), ds = bf16(p (drop(dp) - di) sm_scale), packed
    // as A fragments
    unsigned pv[16], pd[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 qm = *reinterpret_cast<const float2*>(qid + 8 * jj);
      const float4 cs = cst[4 * jj];  // lse log2e and di of the two columns
      float a[4], b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        const bool lo = e < 2, odd = e & 1;
        const float d_i = odd ? cs.w : cs.z;
        const float x = (lo ? kma : kmb) == (odd ? qm.y : qm.x)
                            ? fmaf(s[i], sc2, -(odd ? cs.y : cs.x))
                            : -INFINITY;
        const float p = ex2(x);
        const float m = DROP && !keep(!lo, jj, odd) ? 0.f : ik;
        a[e] = DROP ? p * m : p;
        b[e] = p * (DROP ? fmaf(dp[i], m, -d_i) : dp[i] - d_i) * sm_scale;
      }
      pv[2 * jj] = pack_bf16x2(a[0], a[1]);
      pv[2 * jj + 1] = pack_bf16x2(a[2], a[3]);
      pd[2 * jj] = pack_bf16x2(b[0], b[1]);
      pd[2 * jj + 1] = pack_bf16x2(b[2], b[3]);
    }
    fence_acc(dk);
    fence_acc(dv);
    wgmma_fence();
    issue_rs(dv, pv, d_dot + slot);  // dV += P_v^T dO
    issue_rs(dk, pd, d_qt + slot);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dk);
    fence_acc(dv);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = col + jj * 8 + 2 * t4;
    if (ka < S) {
      const size_t r = (row0 + ka) * ld_g + c;
      *reinterpret_cast<unsigned*>(dk_out + r) =
          pack_bf16x2(dk[4 * jj], dk[4 * jj + 1]);
      *reinterpret_cast<unsigned*>(dv_out + r) =
          pack_bf16x2(dv[4 * jj], dv[4 * jj + 1]);
    }
    if (kb < S) {
      const size_t r = (row0 + kb) * ld_g + c;
      *reinterpret_cast<unsigned*>(dk_out + r) =
          pack_bf16x2(dk[4 * jj + 2], dk[4 * jj + 3]);
      *reinterpret_cast<unsigned*>(dv_out + r) =
          pack_bf16x2(dv[4 * jj + 2], dv[4 * jj + 3]);
    }
  }
}

// -------------------------------------------------------------------- //
// 4. The wgmma + TMA pair, d = 96 (any S)
// -------------------------------------------------------------------- //

// Section 3's kernels on 96-column tiles (flash_wgmma.cuh's, which the
// d = 96 forward shares: a 128-byte- and a 64-byte-swizzled panel, each
// by its own tensor map).  S and dP run 4 k16 steps on panel 0 and 2 on
// panel 1 into one m64n64 accumulator; dQ, dV and dK (96 columns) are an
// m64n64k16 product on panel 0 and an m64n32k16 one on panel 1, 48 f32 a
// thread each.  A dK/dV thread then holds dK and dV
// (96), S and dP (64) and the packed P_v and dS fragments (32): more than
// the 168 registers ptxas gives a thread of a 384-thread block, so the
// dK/dV kernel has no producer warpgroup (its warp 0 fills the ring);
// the dQ kernel (dQ 48, S and dP 64, dS 16) keeps section 3's.  One block
// runs an SM, so shared memory has room for a ring of four slots.
constexpr int STAGES96 = 4;

// The dQ kernel's shared memory at d = 96: DqSmem's with 96-column tiles
// and four ring slots.
struct Dq96Smem {
  static constexpr int Q = 0, DO = Q + 2 * T96, O = DO + 2 * T96;
  static constexpr int K = O + 2 * T96, V = K + STAGES96 * T96;
  static constexpr int IDS = V + STAGES96 * T96;
  static constexpr int DI = IDS + STAGES96 * QT * 4;
  static constexpr int BAR = DI + BLOCK * 4;
  static constexpr int BYTES = 1024 + BAR + (2 * STAGES96 + 1) * 8;
};

// The dK/dV kernel's: DkvSmem's with 96-column tiles and four slots.
struct Dkv96Smem {
  static constexpr int K = 0, V = K + 2 * T96;
  static constexpr int Q = V + 2 * T96, DO = Q + STAGES96 * T96;
  static constexpr int IDS = DO + STAGES96 * T96;
  static constexpr int STAT = IDS + STAGES96 * QT * 4;
  static constexpr int BAR = STAT + STAGES96 * QT * 2 * 4;
  static constexpr int BYTES = 1024 + BAR + (2 * STAGES96 + 1) * 8;
};
static_assert(Dq96Smem::BYTES <= 232448 && Dkv96Smem::BYTES <= 232448,
              "shared memory");

// The dQ kernel at d = 96: per (element, head, 128 queries), keys
// innermost; consumer warpgroup w owns queries 64 w .. + 63 of the block.
template <bool DROP>
__global__ void __launch_bounds__(WTHREADS, 1) flash_dq96_wgmma_kernel(
    const __grid_constant__ PanelMaps tm_q,
    const __grid_constant__ PanelMaps tm_k,
    const __grid_constant__ PanelMaps tm_v,
    const __grid_constant__ PanelMaps tm_o,
    const __grid_constant__ PanelMaps tm_do,
    const float* __restrict__ mask, const float* __restrict__ lse,
    float* __restrict__ di, bf16* __restrict__ dq, int ld_g, int S,
    float sm_scale, DropParams drop) {
  using L = Dq96Smem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* ids = reinterpret_cast<float*>(sm + L::IDS);
  float* sdi = reinterpret_cast<float*>(sm + L::DI);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + STAGES96;
  uint64_t* resident = empty + STAGES96;

  const int head = blockIdx.y, elem = blockIdx.z, col = head * 96;
  const int q0 = blockIdx.x * BLOCK;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * gridDim.y + head) * S;  // Philox row of query 0
  const int n_kt = (S + QT - 1) / QT;
  const float nan = __int_as_float(0x7fc00000);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES96; ++s) {
      mbar_init(&full[s], 129);  // the TMA bytes + the 128 producer threads
      mbar_init(&empty[s], 8);   // one arrive per consumer warp
    }
    mbar_init(resident, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: the resident tiles once, then each key tile's K, V and
    // segment ids, up to STAGES96 tiles ahead of the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    const int tid = threadIdx.x;
    if (tid == 0) {
      mbar_expect_tx(resident, 6 * T96);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tma_tile96(sm + L::Q + h * T96, tm_q, resident, col, q0 + h * QT,
                   elem);
        tma_tile96(sm + L::DO + h * T96, tm_do, resident, col, q0 + h * QT,
                   elem);
        tma_tile96(sm + L::O + h * T96, tm_o, resident, col, q0 + h * QT,
                   elem);
      }
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % STAGES96, k0 = kt * QT;
      mbar_wait(&empty[st], ((kt / STAGES96) & 1) ^ 1);
      if (tid == 0) {
        mbar_expect_tx(&full[st], 2 * T96);
        tma_tile96(sm + L::K + st * T96, tm_k, &full[st], col, k0, elem);
        tma_tile96(sm + L::V + st * T96, tm_v, &full[st], col, k0, elem);
      }
      if (tid < QT)
        ids[st * QT + tid] = k0 + tid < S ? mask[row0 + k0 + tid] : nan;
      mbar_arrive(&full[st]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int ct = threadIdx.x - 128, cw = ct >> 7;
  const int lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  mbar_wait(resident, 0);
  {  // di = rowsum(f32(dO) * f32(O)): two threads a row, columns 0-47 and
     // 48-95 (16-byte chunks 0-5 and 6-11, of which 8-11 lie in panel 1)
    const int r = ct >> 1, rr = r & 63, c0 = (ct & 1) * 6;
    const unsigned char* tdo = sm + L::DO + (r >> 6) * T96;
    const unsigned char* to = sm + L::O + (r >> 6) * T96;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const int ch = c0 + c;
      const int off =
          ch < 8 ? swizzle128(rr, ch) : QTILE + swizzle64(rr, ch - 8);
      sum = dot8(sum, *reinterpret_cast<const uint4*>(tdo + off),
                 *reinterpret_cast<const uint4*>(to + off));
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((ct & 1) == 0) {
      sdi[r] = sum;
      if (q0 + r < S) di[prow0 + q0 + r] = sum;
    }
  }
  consumer_sync();

  const int ra = cw * 64 + ((ct >> 5) & 3) * 16 + g;  // block rows ra, +8
  const int qa = q0 + ra, qb = qa + 8;
  // the Philox row this lane draws: row lane / 2 of the warp's 16
  const int drow = prow0 + q0 + (ra - g) + (lane >> 1);
  // a query past S matches no key (NaN), so its p is 0 whatever its lse
  const float qma = qa < S ? mask[row0 + qa] : nan;
  const float qmb = qb < S ? mask[row0 + qb] : nan;
  // p sm_scale = 2^(s sm_scale log2e - (lse log2e - log2 sm_scale))
  const float l2s = log2f(sm_scale);
  const float la = (qa < S ? lse[prow0 + qa] * LOG2E : 0.f) - l2s;
  const float lb = (qb < S ? lse[prow0 + qb] * LOG2E : 0.f) - l2s;
  const float dia = sdi[ra], dib = sdi[ra + 8];
  const float sc2 = sm_scale * LOG2E, ik = drop.inv_keep;
  const unsigned base = smem_addr(sm), a_q = base + L::Q + cw * T96;

  float acc[32], acc1[16];  // dq columns 0-63, 64-95
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc1[i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % STAGES96;
    const unsigned a_k = base + L::K + st * T96, a_qo = opaque(a_q);
    mbar_wait(&full[st], (kt / STAGES96) & 1);
    float s[32], dp[32];
    wgmma_fence();
    issue_nt96(s, a_qo, a_k);
    issue_nt96(dp, a_qo + (L::DO - L::Q), a_k + (L::V - L::K));
    wgmma_commit();
    // the keep bits while the products run
    const KeepQ<DROP> keep(
        DROP ? draw_rows(drop, drow, kt * QT + 4 * (lane & 1)) : 0u, lane);
    const float* kid = ids + st * QT + 2 * t4;
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    // ds = bf16(p (drop(dp) - di) sm_scale), packed as A fragments
    unsigned pa[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 km = *reinterpret_cast<const float2*>(kid + 8 * jj);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        const bool lo = e < 2;
        const float d_i = lo ? dia : dib;
        const float x = ((e & 1) ? km.y : km.x) == (lo ? qma : qmb)
                            ? fmaf(s[i], sc2, -(lo ? la : lb))
                            : -INFINITY;
        // drop(dp) - di: dp * (keep ? inv_keep : 0) - di
        const float dm =
            DROP ? fmaf(dp[i], keep(!lo, jj, e & 1) ? ik : 0.f, -d_i)
                 : dp[i] - d_i;
        v[e] = ex2(x) * dm;
      }
      pa[2 * jj] = pack_bf16x2(v[0], v[1]);
      pa[2 * jj + 1] = pack_bf16x2(v[2], v[3]);
    }
    fence_acc(acc);
    fence_acc(acc1);
    wgmma_fence();
    issue_rs96(acc, acc1, pa, a_k);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_acc(acc1);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  if (qa < S) store96(dq, (row0 + qa) * ld_g, col, t4, false, acc, acc1);
  if (qb < S) store96(dq, (row0 + qb) * ld_g, col, t4, true, acc, acc1);
}

// The dK/dV kernel at d = 96: per (element, head, 128 keys), queries
// innermost; warpgroup w owns keys 64 w .. + 63 of the block, and warp 0
// also fills the ring, as flash_attention.cu's forward does: ptxas holds
// every thread of a block to the registers its thread count leaves (168
// at 384 threads, whatever setmaxnreg gives at run time), and a thread
// here needs more (dK, dV, S, dP, P_v, dS: 224; 260 B spilled at 384).
template <bool DROP>
__global__ void __launch_bounds__(256, 1) flash_dkv96_wgmma_kernel(
    const __grid_constant__ PanelMaps tm_q,
    const __grid_constant__ PanelMaps tm_k,
    const __grid_constant__ PanelMaps tm_v,
    const __grid_constant__ PanelMaps tm_do,
    const float* __restrict__ mask, const float* __restrict__ lse,
    const float* __restrict__ di, bf16* __restrict__ dk_out,
    bf16* __restrict__ dv_out, int ld_g, int S, float sm_scale,
    DropParams drop) {
  using L = Dkv96Smem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* ids = reinterpret_cast<float*>(sm + L::IDS);
  float* stat = reinterpret_cast<float*>(sm + L::STAT);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + STAGES96;
  uint64_t* resident = empty + STAGES96;

  const int head = blockIdx.y, elem = blockIdx.z, col = head * 96;
  const int k0 = blockIdx.x * BLOCK;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * gridDim.y + head) * S;  // Philox row of query 0
  const int n_qt = (S + QT - 1) / QT;
  const float nan = __int_as_float(0x7fc00000);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES96; ++s) {
      mbar_init(&full[s], 33);  // the TMA bytes + warp 0's 32 lanes
      mbar_init(&empty[s], 8);  // one arrive per warp
    }
    mbar_init(resident, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int ct = threadIdx.x, cw = ct >> 7;
  const int lane = ct & 31, g = lane >> 2, t4 = lane & 3;
  const bool loader = ct < 32;  // warp 0 fills the ring
  // query tile qt's Q, dO (lane 0, by TMA), segment ids, lse and di into
  // its slot
  auto fill = [&](int qt) {
    const int st = qt % STAGES96, q0 = qt * QT;
    if (lane == 0) {
      mbar_expect_tx(&full[st], 2 * T96);
      tma_tile96(sm + L::Q + st * T96, tm_q, &full[st], col, q0, elem);
      tma_tile96(sm + L::DO + st * T96, tm_do, &full[st], col, q0, elem);
    }
    for (int j = lane; j < QT; j += 32) {
      const int q = q0 + j;
      const bool ok = q < S;
      ids[st * QT + j] = ok ? mask[row0 + q] : nan;
      float* p = stat + st * QT * 2 + (j >> 1) * 4 + (j & 1);
      p[0] = ok ? lse[prow0 + q] * LOG2E : 0.f;
      p[2] = ok ? di[prow0 + q] : 0.f;
    }
    mbar_arrive(&full[st]);
  };
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(resident, 4 * T96);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tma_tile96(sm + L::K + h * T96, tm_k, resident, col, k0 + h * QT,
                   elem);
        tma_tile96(sm + L::V + h * T96, tm_v, resident, col, k0 + h * QT,
                   elem);
      }
    }
    for (int qt = 0; qt < STAGES96 && qt < n_qt; ++qt) fill(qt);
  }
  const int ra = cw * 64 + ((ct >> 5) & 3) * 16 + g;  // block keys ra, +8
  const int ka = k0 + ra, kb = ka + 8;
  // the keys and the Philox row of the first query this lane draws
  const int dcol = k0 + (ra - g) + 4 * (lane >> 3);
  const int drow = prow0 + 2 * ((lane >> 1) & 3) + 32 * (lane & 1);
  // a key past S matches no query (NaN), so its p is 0
  const float kma = ka < S ? mask[row0 + ka] : nan;
  const float kmb = kb < S ? mask[row0 + kb] : nan;
  const float sc2 = sm_scale * LOG2E, ik = drop.inv_keep;
  const unsigned base = smem_addr(sm), a_k = base + L::K + cw * T96;
  mbar_wait(resident, 0);

  float dk[32], dk1[16], dv[32], dv1[16];  // columns 0-63, 64-95
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) dk1[i] = dv1[i] = 0.f;
  for (int qt = 0; qt < n_qt; ++qt) {
    // the slot tile qt - 2 held takes tile qt + 2 once every warp is done
    // with it (rarely a wait: two tiles have passed since)
    if (loader && qt >= 2 && qt + 2 < n_qt) {
      mbar_wait(&empty[(qt - 2) % STAGES96], ((qt - 2) / STAGES96) & 1);
      fill(qt + 2);
    }
    const int st = qt % STAGES96;
    const unsigned a_q = base + L::Q + st * T96, a_ko = opaque(a_k);
    mbar_wait(&full[st], (qt / STAGES96) & 1);
    float s[32], dp[32];  // S^T, dP^T: rows keys, columns queries
    wgmma_fence();
    issue_nt96(s, a_ko, a_q);
    issue_nt96(dp, a_ko + (L::V - L::K), a_q + (L::DO - L::Q));
    wgmma_commit();
    // the keep bits while the products run
    const KeepKV<DROP> keep(
        DROP ? draw_keys<2>(drop, drow + qt * QT, dcol) : 0u, lane);
    const float* qid = ids + st * QT + 2 * t4;
    const float4* cst = reinterpret_cast<const float4*>(stat + st * QT * 2) +
                        t4;
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    // p_v = bf16(drop(p)), ds = bf16(p (drop(dp) - di) sm_scale), packed
    // as A fragments
    unsigned pv[16], pd[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 qm = *reinterpret_cast<const float2*>(qid + 8 * jj);
      const float4 cs = cst[4 * jj];  // lse log2e and di of the two columns
      float a[4], b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e;
        const bool lo = e < 2, odd = e & 1;
        const float d_i = odd ? cs.w : cs.z;
        const float x = (lo ? kma : kmb) == (odd ? qm.y : qm.x)
                            ? fmaf(s[i], sc2, -(odd ? cs.y : cs.x))
                            : -INFINITY;
        const float p = ex2(x);
        const float m = DROP && !keep(!lo, jj, odd) ? 0.f : ik;
        a[e] = DROP ? p * m : p;
        b[e] = p * (DROP ? fmaf(dp[i], m, -d_i) : dp[i] - d_i) * sm_scale;
      }
      pv[2 * jj] = pack_bf16x2(a[0], a[1]);
      pv[2 * jj + 1] = pack_bf16x2(a[2], a[3]);
      pd[2 * jj] = pack_bf16x2(b[0], b[1]);
      pd[2 * jj + 1] = pack_bf16x2(b[2], b[3]);
    }
    fence_acc(dk);
    fence_acc(dk1);
    fence_acc(dv);
    fence_acc(dv1);
    wgmma_fence();
    issue_rs96(dv, dv1, pv, a_q + (L::DO - L::Q));  // dV += P_v^T dO
    issue_rs96(dk, dk1, pd, a_q);                   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dk);
    fence_acc(dk1);
    fence_acc(dv);
    fence_acc(dv1);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  if (ka < S) {
    const size_t r = (row0 + ka) * ld_g;
    store96(dk_out, r, col, t4, false, dk, dk1);
    store96(dv_out, r, col, t4, false, dv, dv1);
  }
  if (kb < S) {
    const size_t r = (row0 + kb) * ld_g;
    store96(dk_out, r, col, t4, true, dk, dk1);
    store96(dv_out, r, col, t4, true, dv, dv1);
  }
}

struct Operands {  // host side only: the kernels take them as arguments
  const bf16 *q, *k, *v, *o, *dout;
  const float *mask, *lse;
  float* di;
  bf16 *dq, *dk, *dv;
  int ld, ld_g, B, S, n_heads, dh;
  float sm_scale;
  DropParams drop;
};

template <int D, bool DROP>
int launch_dq(const Operands& a, cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel<D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.S + ROWS - 1) / ROWS, a.n_heads, a.B);
  flash_dq_kernel<D, DROP><<<grid, THREADS, smem, stream>>>(
      a.q, a.k, a.v, a.ld, a.o, a.dout, a.mask, a.lse, a.di, a.dq, a.ld_g,
      a.S, a.dh, a.sm_scale, a.drop);
  return (int)cudaGetLastError();
}

template <int D, bool DROP>
int launch_dkv(const Operands& a, cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_kernel<D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.S + ROWS - 1) / ROWS, a.n_heads, a.B);
  flash_dkv_kernel<D, DROP><<<grid, THREADS, smem, stream>>>(
      a.q, a.k, a.v, a.ld, a.dout, a.mask, a.lse, a.di, a.dk, a.dv, a.ld_g,
      a.S, a.dh, a.sm_scale, a.drop);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Operands& a, bool dkv, cudaStream_t stream) {
  if (dkv)
    return a.drop.on ? launch_dkv<D, true>(a, stream)
                     : launch_dkv<D, false>(a, stream);
  return a.drop.on ? launch_dq<D, true>(a, stream)
                   : launch_dq<D, false>(a, stream);
}

// launches of the wgmma pairs' dQ and dK/dV kernels, at d = 64 and 96
long long wgmma_launches[2][2] = {{0, 0}, {0, 0}};

int rows_map(CUtensorMap* m, const void* p, int ld, const Operands& a) {
  return flash::rows_map(m, p, ld, a.n_heads, a.S, a.B);
}

int panel_maps(PanelMaps* m, const void* p, int ld, const Operands& a) {
  return flash::panel_maps(m, p, ld, a.n_heads, a.S, a.B);
}

template <bool DROP>
int launch_dq_wgmma(const Operands& a, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_dq_wgmma_kernel<DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, DqSmem::BYTES);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int H = a.n_heads * WD;
  CUtensorMap tq, tk, tv, to, tdo;
  int rc = rows_map(&tq, a.q, a.ld, a);
  if (rc == 0) rc = rows_map(&tk, a.k, a.ld, a);
  if (rc == 0) rc = rows_map(&tv, a.v, a.ld, a);
  if (rc == 0) rc = rows_map(&to, a.o, H, a);
  if (rc == 0) rc = rows_map(&tdo, a.dout, H, a);
  if (rc != 0) return rc;
  dim3 grid((a.S + BLOCK - 1) / BLOCK, a.n_heads, a.B);
  flash_dq_wgmma_kernel<DROP><<<grid, WTHREADS, DqSmem::BYTES, stream>>>(
      tq, tk, tv, to, tdo, a.mask, a.lse, a.di, a.dq, a.ld_g, a.S,
      a.sm_scale, a.drop);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++wgmma_launches[0][0];
  return (int)e;
}

template <bool DROP>
int launch_dkv_wgmma(const Operands& a, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_dkv_wgmma_kernel<DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, DkvSmem::BYTES);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  CUtensorMap tq, tk, tv, tdo;
  int rc = rows_map(&tq, a.q, a.ld, a);
  if (rc == 0) rc = rows_map(&tk, a.k, a.ld, a);
  if (rc == 0) rc = rows_map(&tv, a.v, a.ld, a);
  if (rc == 0) rc = rows_map(&tdo, a.dout, a.n_heads * WD, a);
  if (rc != 0) return rc;
  dim3 grid((a.S + BLOCK - 1) / BLOCK, a.n_heads, a.B);
  flash_dkv_wgmma_kernel<DROP><<<grid, WTHREADS, DkvSmem::BYTES, stream>>>(
      tq, tk, tv, tdo, a.mask, a.lse, a.di, a.dk, a.dv, a.ld_g, a.S,
      a.sm_scale, a.drop);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++wgmma_launches[0][1];
  return (int)e;
}

template <bool DROP>
int launch_dq96_wgmma(const Operands& a, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_dq96_wgmma_kernel<DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Dq96Smem::BYTES);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int H = a.n_heads * 96;
  PanelMaps tq, tk, tv, to, tdo;
  int rc = panel_maps(&tq, a.q, a.ld, a);
  if (rc == 0) rc = panel_maps(&tk, a.k, a.ld, a);
  if (rc == 0) rc = panel_maps(&tv, a.v, a.ld, a);
  if (rc == 0) rc = panel_maps(&to, a.o, H, a);
  if (rc == 0) rc = panel_maps(&tdo, a.dout, H, a);
  if (rc != 0) return rc;
  dim3 grid((a.S + BLOCK - 1) / BLOCK, a.n_heads, a.B);
  flash_dq96_wgmma_kernel<DROP><<<grid, WTHREADS, Dq96Smem::BYTES, stream>>>(
      tq, tk, tv, to, tdo, a.mask, a.lse, a.di, a.dq, a.ld_g, a.S,
      a.sm_scale, a.drop);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++wgmma_launches[1][0];
  return (int)e;
}

template <bool DROP>
int launch_dkv96_wgmma(const Operands& a, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_dkv96_wgmma_kernel<DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Dkv96Smem::BYTES);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  PanelMaps tq, tk, tv, tdo;
  int rc = panel_maps(&tq, a.q, a.ld, a);
  if (rc == 0) rc = panel_maps(&tk, a.k, a.ld, a);
  if (rc == 0) rc = panel_maps(&tv, a.v, a.ld, a);
  if (rc == 0) rc = panel_maps(&tdo, a.dout, a.n_heads * 96, a);
  if (rc != 0) return rc;
  dim3 grid((a.S + BLOCK - 1) / BLOCK, a.n_heads, a.B);
  flash_dkv96_wgmma_kernel<DROP><<<grid, 256, Dkv96Smem::BYTES, stream>>>(
          tq, tk, tv, tdo, a.mask, a.lse, a.di, a.dk, a.dv, a.ld_g, a.S,
          a.sm_scale, a.drop);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++wgmma_launches[1][1];
  return (int)e;
}

// d = 64 and d = 96: the wgmma + TMA pairs; every other d <= 256 with d %
// 8 == 0: the mma.sync pair, instance_width(d) wide.
int dispatch(Operands a, int d, bool dkv, void* cuda_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  if (d == WD) {
    if (dkv)
      return a.drop.on ? launch_dkv_wgmma<true>(a, s)
                       : launch_dkv_wgmma<false>(a, s);
    return a.drop.on ? launch_dq_wgmma<true>(a, s)
                     : launch_dq_wgmma<false>(a, s);
  }
  if (d == 96) {
    if (dkv)
      return a.drop.on ? launch_dkv96_wgmma<true>(a, s)
                       : launch_dkv96_wgmma<false>(a, s);
    return a.drop.on ? launch_dq96_wgmma<true>(a, s)
                     : launch_dq96_wgmma<false>(a, s);
  }
  a.dh = d;
  switch (instance_width(d)) {
    case 32: return launch<32>(a, dkv, s);
    case 64: return launch<64>(a, dkv, s);
    case 96: return launch<96>(a, dkv, s);
    case 128: return launch<128>(a, dkv, s);
    case 192: return launch<192>(a, dkv, s);
    case 256: return launch<256>(a, dkv, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The dQ kernel: q, k, v as nbk_flash_fwd reads them (row stride ld), o
// and dout (B*S, n_heads * d) bf16, mask (B, S) f32, lse (B, n_heads, S)
// f32 from nbk_flash_fwd -> dq bf16 with row stride ld_g (16-byte
// aligned, ld_g even) and di (B, n_heads, S) f32 = rowsum(dout * o), which
// nbk_flash_bwd_dkv reads.  Any d >= 1; the prob dropout as in the
// forward.  At d = 64 and 96 q, k, v, o and dout must be 16-byte aligned
// with row strides of a multiple of 16 bytes (TMA); at the chunked head
// dims any alignment goes.
int nbk_flash_bwd_dq(const void* q, const void* k, const void* v, int ld,
                     const void* o, const void* dout, const float* mask,
                     const float* lse, float* di, void* dq, int ld_g, int B,
                     int S, int n_heads, int d, float sm_scale,
                     unsigned long long seed, int stream, unsigned thresh,
                     float inv_keep, int drop_on, void* cuda_stream) {
  if (chunked_head_dim(d))
    return nbk_chunked_bwd_dq(q, k, v, ld, o, dout, mask, lse, nullptr, di,
                              dq, ld_g, B, S, n_heads, d, sm_scale, seed,
                              stream, thresh, inv_keep, drop_on, cuda_stream);
  Operands a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.mask = mask;
  a.lse = lse;
  a.di = di;
  a.dq = static_cast<bf16*>(dq);
  a.ld = ld;
  a.ld_g = ld_g;
  a.B = B;
  a.S = S;
  a.n_heads = n_heads;
  a.sm_scale = sm_scale;
  a.drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  return dispatch(a, d, false, cuda_stream);
}

// The dK/dV kernel: the same q, k, v, dout, mask and lse, di from
// nbk_flash_bwd_dq -> dk, dv bf16 with row stride ld_g.
int nbk_flash_bwd_dkv(const void* q, const void* k, const void* v, int ld,
                      const void* dout, const float* mask, const float* lse,
                      const float* di, void* dk, void* dv, int ld_g, int B,
                      int S, int n_heads, int d, float sm_scale,
                      unsigned long long seed, int stream, unsigned thresh,
                      float inv_keep, int drop_on, void* cuda_stream) {
  if (chunked_head_dim(d))
    return nbk_chunked_bwd_dkv(q, k, v, ld, dout, mask, lse, nullptr, di, dk,
                               dv, ld_g, B, S, n_heads, d, sm_scale, seed,
                               stream, thresh, inv_keep, drop_on,
                               cuda_stream);
  Operands a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.mask = mask;
  a.lse = lse;
  a.di = const_cast<float*>(di);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.ld = ld;
  a.ld_g = ld_g;
  a.B = B;
  a.S = S;
  a.n_heads = n_heads;
  a.sm_scale = sm_scale;
  a.drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  return dispatch(a, d, true, cuda_stream);
}

// Launches of the wgmma + TMA pairs' dQ (dkv = 0) or dK/dV (dkv = 1)
// kernel since the library was loaded, at head dim d (64 or 96; 0: both;
// any other d: 0) -- a routing check: the pairs run exactly at d = 64
// and 96.
long long nbk_flash_bwd_wgmma_launches(int dkv, int d) {
  const int k = dkv ? 1 : 0;
  return d == 64   ? wgmma_launches[0][k]
         : d == 96 ? wgmma_launches[1][k]
         : d == 0  ? wgmma_launches[0][k] + wgmma_launches[1][k]
                   : 0;
}

}  // extern "C"
