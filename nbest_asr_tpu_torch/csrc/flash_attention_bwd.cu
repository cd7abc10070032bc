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
//   1. the dQ kernel, per (element, head, 64-query tile), keys innermost:
//      its prologue computes di for its rows from the O and dO tiles and
//      stores it for kernel 2;
//   2. the dK/dV kernel, per (element, head, 64-key tile), queries
//      innermost: keys are the warps' rows, so S^T = K Q^T and dP^T = V
//      dO^T come out as C fragments that are directly the A fragments of
//      dV += P_v^T dO and dK += dS^T Q.
// q, k, v are read by row stride as the forward reads them, dO and O are
// (b, s, heads, d), dq, dk, dv are written with their own row stride:
// no transposes, no padding.  Each tile's 64 x 64 keep bits are drawn into
// a shared bit table (attention.cuh), so both kernels regenerate the
// forward's mask whatever their loop order.
//
// Design: the single-block backward's (seg_attention_bwd.cu) 16-column
// chunk products, with tile-local segment ids, statistics and keep bits
// so that shared memory does not grow with S.  What bounds it on the H100:
// 6 (dQ) and 8 (dK/dV) b h s^2 d tensor-core operations against a few
// bytes per row -- operations, at the rate mma.sync reaches on 64-row
// tiles.
#include "attention.cuh"

namespace {

using namespace nbk;
using namespace nbk::attn;

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

// Blocks per SM: 4 at d <= 64 (128 registers), 1 at d = 128.
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : 1)
    flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, int ld,
                    const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    const float* __restrict__ mask,
                    const float* __restrict__ lse, float* __restrict__ di,
                    bf16* __restrict__ dq, int ld_g, int S, float sm_scale,
                    DropParams drop) {
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
  const int H = n_heads * D;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;
  const size_t off = row0 * ld + head * D;
  const size_t off_h = row0 * H + head * D;
  const bf16* k_src = k + off;
  const bf16* v_src = v + off;
  const float* mrow = mask + row0;

  load_tile<D>(sQ, q + off, q0, S, ld);
  load_tile<D>(sO, dout + off_h, q0, S, H);
  load_tile<D>(sOut, o + off_h, q0, S, H);
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
    load_tile<D>(sK, k_src, k0, S, ld);
    load_tile<D>(sV, v_src, k0, S, ld);
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

// Blocks per SM: 4 at d <= 64 (128 registers), 1 at d = 128 (the K and V
// fragments and both accumulators alone take 192 registers).
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : 1)
    flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, int ld,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ mask,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dk_out,
                     bf16* __restrict__ dv_out, int ld_g, int S,
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
  const int H = n_heads * D;
  const size_t row0 = (size_t)elem * S;
  const int prow0 = (elem * n_heads + head) * S;
  const size_t off = row0 * ld + head * D;
  const bf16* q_src = q + off;
  const bf16* o_src = dout + row0 * H + head * D;
  const float* mrow = mask + row0;

  load_tile<D>(sK, k + off, k0, S, ld);
  load_tile<D>(sV, v + off, k0, S, ld);
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
    load_tile<D>(sQ, q_src, qt0, S, ld);
    load_tile<D>(sO, o_src, qt0, S, H);
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
  const bf16 *q, *k, *v, *o, *dout;
  const float *mask, *lse;
  float* di;
  bf16 *dq, *dk, *dv;
  int ld, ld_g, B, S, n_heads;
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
      a.S, a.sm_scale, a.drop);
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
      a.S, a.sm_scale, a.drop);
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

int dispatch(const Operands& a, int d, bool dkv, void* cuda_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  if (d == 32) return launch<32>(a, dkv, s);
  if (d == 64) return launch<64>(a, dkv, s);
  if (d == 128) return launch<128>(a, dkv, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The dQ kernel: q, k, v as nbk_flash_fwd reads them (row stride ld), o
// and dout (B*S, n_heads * d) bf16, mask (B, S) f32, lse (B, n_heads, S)
// f32 from nbk_flash_fwd -> dq bf16 with row stride ld_g (16-byte
// aligned, ld_g even) and di (B, n_heads, S) f32 = rowsum(dout * o), which
// nbk_flash_bwd_dkv reads.  d in {32, 64, 128}; the prob dropout as in the
// forward.
int nbk_flash_bwd_dq(const void* q, const void* k, const void* v, int ld,
                     const void* o, const void* dout, const float* mask,
                     const float* lse, float* di, void* dq, int ld_g, int B,
                     int S, int n_heads, int d, float sm_scale,
                     unsigned long long seed, int stream, unsigned thresh,
                     float inv_keep, int drop_on, void* cuda_stream) {
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

}  // extern "C"
