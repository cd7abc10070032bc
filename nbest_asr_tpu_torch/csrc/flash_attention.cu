// Tiled flash-attention forward: online softmax over 64-key tiles, one
// block per (element, head, 64-query tile), for any sequence length.
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
// mask (seg_attention.cu), whatever the tiling.
//
// Design (FlashAttention-2 on mma.sync): 4 warps x 16 query rows; the q
// fragments stay in registers for the whole key sweep; each 64-key tile
// of K and V arrives by cp.async into one of two shared buffers while the
// previous tile is computed, with its 64 segment ids and its 64 x 64 keep
// bits (one Philox call per four probs, drawn once per block into a
// shared bit table, attention.cuh).  The score C fragments become, after
// the exp, the A fragments of P . V (P rounded to bf16 unnormalised, as
// FlashAttention does; the TPU kernel multiplies in f32 at HIGHEST
// precision).
//
// What bounds it on the H100: 4 b h s^2 d tensor-core operations against
// 8 b s h + 4 b s + 4 b h s bytes -- at s = 1024, d = 64 about 500
// operations a byte, above the card's 295: the MMA rate bounds it, and
// mma.sync with a 64 x 64 tile reaches a fraction of it (wgmma with TMA
// is a later step).
#include "attention.cuh"

namespace {

using namespace nbk;
using namespace nbk::attn;

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
                                           const DropParams& drop,
                                           int prow_q0) {
  load_tile<D>(sK, k_src, k0, S, ld);
  load_tile<D>(sV, v_src, k0, S, ld);
  cp_async_commit();
  for (int j = threadIdx.x; j < KT; j += THREADS)
    sMk[j] = k0 + j < S ? mrow[k0 + j] : 0.f;
  if (DROP) build_keep(sKeep, ROWS, KWORDS, KSTRIDE, drop, prow_q0, k0);
}

// Blocks per SM: 4 at d <= 64 (128 registers, 48 KB of shared memory at
// d = 64), 2 at d = 128 (87 KB; the fragments and the accumulator take
// ~96 registers before the scores).
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : 2)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, int ld,
                     const float* __restrict__ mask, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, float sm_scale,
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
  const int H = n_heads * D;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;  // Philox row of query 0
  const size_t off = row0 * ld + head * D;
  const bf16* k_src = k + off;
  const bf16* v_src = v + off;
  const float* mrow = mask + row0;

  load_tile<D>(sQ, q + off, q0, S, ld);
  cp_async_commit();
  stage_tile<D, DROP>(sK, sV, sMk, sKeep, k_src, v_src, ld, mrow, 0, S, drop,
                      prow0 + q0);

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
                          mrow, (kt + 1) * KT, S, drop, prow0 + q0);
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
    const int col = head * D + dt * 8 + 2 * t4;
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
                  int n_heads, float sm_scale, const DropParams& drop,
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
      sm_scale, drop);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, int ld,
           const float* mask, void* o, float* lse, int B, int S, int n_heads,
           float sm_scale, const DropParams& drop, cudaStream_t stream) {
  if (drop.on)
    return launch_kernel<D, true>(q, k, v, ld, mask, o, lse, B, S, n_heads,
                                  sm_scale, drop, stream);
  return launch_kernel<D, false>(q, k, v, ld, mask, o, lse, B, S, n_heads,
                                 sm_scale, drop, stream);
}

}  // namespace

extern "C" {

// q, k, v: (B*S, ld) bf16 row-major, each operand's (n_heads * d) columns
// starting at its pointer (16-byte aligned, ld % 8 == 0); mask (B, S) f32
// segment ids -> o (B*S, n_heads * d) bf16 and lse (B, n_heads, S) f32.
// d in {32, 64, 128}, any S >= 1.  Prob dropout when drop_on (philox.cuh).
int nbk_flash_fwd(const void* q, const void* k, const void* v, int ld,
                  const float* mask, void* o, float* lse, int B, int S,
                  int n_heads, int d, float sm_scale,
                  unsigned long long seed, int stream, unsigned thresh,
                  float inv_keep, int drop_on, void* cuda_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const DropParams drop = make_drop(seed, stream, thresh, inv_keep, drop_on);
  if (d == 32)
    return launch<32>(q, k, v, ld, mask, o, lse, B, S, n_heads, sm_scale,
                      drop, s);
  if (d == 64)
    return launch<64>(q, k, v, ld, mask, o, lse, B, S, n_heads, sm_scale,
                      drop, s);
  if (d == 128)
    return launch<128>(q, k, v, ld, mask, o, lse, B, S, n_heads, sm_scale,
                       drop, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
