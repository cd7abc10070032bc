// Segment-masked softmax attention per (element, head, 64-query tile):
// q, k and v are read by row stride and column offset -- the three column
// blocks of the (n, 3h) QKV buffer, or standalone (b, s, heads, d)
// tensors -- and ctx is written (n, h), with no head transposes.
// Training adds the Philox prob dropout and each row's softmax
// statistics.
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
// Contract kept: SEGMENT-mask semantics (a query attends exactly the
// keys carrying its own mask value; pads attend pads), masked scores
// filled with MASK_VALUE (-0.7 * FLT_MAX), a PLAIN softmax in f32 over
// the whole row (p = exp(s - max) / sum, seq <= 512), then p = keep ? p *
// f32(1 / (1 - rate)) : 0 in f32, probs rounded to bf16 before P.V, f32
// accumulation, ctx rounded to bf16.  Keys past the sequence end are
// excluded outright, which is what the TPU wrappers' -1 mask padding
// achieves (fused_attention.py:791-797, flash_attention.py:634-639), so
// nothing is padded.  The keep bits are Philox stream 3 at row (elem *
// n_heads + head) * S + q, column k (attention.cuh), so the backward
// kernels -- and the tiled flash kernels, at any tiling -- regenerate
// them.
//
// Design: the TPU kernel holds the whole (s, s) score matrix in VMEM.
// Here a warp owns 16 query rows and the row statistics live in
// registers: pass 1 sweeps the key tiles for the row max and sum (the
// sum rescaled as the max grows), pass 2 recomputes the same scores
// bit for bit, normalises them exactly, drops them, rounds to bf16 and
// feeds them from registers straight into the P.V tensor-core MMA (the C
// fragment of S is the A fragment of P).  Recomputing QK^T costs one
// extra s*s*d MMA per head -- small beside the layer's GEMMs -- and keeps
// shared memory at three 64-row tiles plus the block's keep bits (64 x S
// bits), so many blocks fit on an SM.  The max and sum it writes (8
// bytes a row) let the backward rebuild p without pass 1.
//
// What bounds it on the H100: at s <= 512 the per-head work is a few
// MFLOP on 2*s*d*2 bytes of K and V, so latency of the small tiles and
// the serial tile loop bound it, not HBM or tensor-core rate; the keep
// bits add one 10-round Philox call per four probs, drawn once per block.
#include "attention.cuh"

namespace {

using namespace nbk;
using namespace nbk::attn;

constexpr int KT = 64;  // keys per tile

template <int D>
size_t smem_bytes(int S) {
  return (size_t)3 * Tile<D>::ELEMS * sizeof(bf16) +
         (size_t)S * sizeof(float) +
         (size_t)ROWS * keep_stride(S) * sizeof(unsigned);
}

// Blocks per SM each instance is built for (registers <= 65536 / (128 x
// blocks)): the d = 32 and 64 instances at 4 (128 registers; the d = 64
// serving one needs 130 unbounded, which cost 20% at seq 256 on the
// H100), the d = 128 ones where they fall unbounded, the d = 192 and 256
// ones at 1 (their q fragments and accumulators alone take 144 and 192
// registers).  q, k, v: row 0, column 0 of the head block of each
// operand, ld its row stride (elements); ctx has rows of n_heads * D.
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, D <= 64     ? 4
                                           : D == 128 ? (DROP ? 2 : 3)
                                                      : 1)
    seg_attention_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, int ld,
                         const float* __restrict__ mask,
                         bf16* __restrict__ ctx, float* __restrict__ stats,
                         int S, float sm_scale, DropParams drop) {
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
  const int H = n_heads * D;
  const size_t off = row0 * ld + head * D;
  const bf16* q_src = q + off;
  const bf16* k_src = k + off;
  const bf16* v_src = v + off;

  for (int j = threadIdx.x; j < S; j += THREADS) sM[j] = mask[row0 + j];
  load_tile<D>(sQ, q_src, q0, S, ld);
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
    load_tile<D>(sK, k_src, kt * KT, S, ld);
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
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<D>(sK, k_src, kt * KT, S, ld);
    load_tile<D>(sV, v_src, kt * KT, S, ld);
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
          p[j][c] = c < 2 ? expf(sc[nt][c] - ma) / la
                          : expf(sc[nt][c] - mb) / lb;
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
    const int col = head * D + dt * 8 + 2 * t4;
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
                  int n_heads, float sm_scale, const DropParams& drop,
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
      S, sm_scale, drop);
  return (int)cudaGetLastError();
}

// the serving forward (no dropout) compiles without the keep-bit code
template <int D>
int launch(const void* q, const void* k, const void* v, int ld,
           const float* mask, void* ctx, float* stats, int B, int S,
           int n_heads, float sm_scale, const DropParams& drop,
           cudaStream_t stream) {
  if (drop.on)
    return launch_kernel<D, true>(q, k, v, ld, mask, ctx, stats, B, S,
                                  n_heads, sm_scale, drop, stream);
  return launch_kernel<D, false>(q, k, v, ld, mask, ctx, stats, B, S,
                                 n_heads, sm_scale, drop, stream);
}

}  // namespace

extern "C" {

// q, k, v: (B*S, ld) bf16 row-major with each operand's (n_heads * d)
// columns starting at its pointer (16-byte aligned, ld % 8 == 0) -- the
// q | k | v column blocks of one (B*S, 3h) QKV buffer (ld = 3h), or
// (B, S, n_heads, d) tensors (ld = n_heads * d); mask (B, S) f32 segment
// ids -> ctx (B*S, n_heads * d) bf16.  d in {32, 64, 128, 192, 256}, S <=
// 512.  stats, if not null, is (2, B, n_heads, S) f32 and receives each
// row's max and sum of exp.  Prob dropout when drop_on (seed, stream,
// thresh, inv_keep as in philox.cuh).
int nbk_seg_attention(const void* q, const void* k, const void* v, int ld,
                      const float* mask, void* ctx, float* stats, int B,
                      int S, int n_heads, int d, float sm_scale,
                      unsigned long long seed, int stream, unsigned thresh,
                      float inv_keep, int drop_on, void* cuda_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const DropParams drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
#define NBK_SEG_ATTN(D)                                                   \
  if (d == D)                                                             \
    return launch<D>(q, k, v, ld, mask, ctx, stats, B, S, n_heads,        \
                     sm_scale, drop, s);
  NBK_SEG_ATTN(32)
  NBK_SEG_ATTN(64)
  NBK_SEG_ATTN(128)
  NBK_SEG_ATTN(192)
  NBK_SEG_ATTN(256)
#undef NBK_SEG_ATTN
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
