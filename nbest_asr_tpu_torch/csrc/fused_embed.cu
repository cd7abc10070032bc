// Fused embedding lookup: per token row t of the flat (M,) ids,
//   x = f32(word[ids[t]]) + f32(pos[t % seq_len]) + f32(type[tids[t]])
//   out[t] = (x - mean) * rstd * scale + bias    (f32 statistics)
// written in the tables' dtype (f32 masters, or bf16).
//
// Replaces nbest_asr_tpu/ops/fused_embed.py:_embed_kernel (:48).  The TPU
// kernel DMAs each token's aligned 8-row group of the word table from HBM
// and picks the row with a one-hot matmul, and selects the type rows the
// same way: Mosaic workarounds for unaligned row slices.  Here one warp
// owns one token row and reads its word, position and type rows straight
// from global memory by index (four columns a lane per 128, N = 128 * NV
// <= 1024).  The position table arrives sliced at the model's
// position_offset, as in JAX (encoder.py:182-183).  A null tids reads type
// row 0 for every token (JAX passes zeros there).  Out-of-range ids read
// what the TPU kernel reads: a type id outside its table a zero row (its
// one-hot select), a word id in the table's padding to a multiple of 8 a
// zero row (the padded row group); a word id below 0 or past the padding,
// where the TPU kernel's DMA faults, writes a NaN row.
//
// What bounds it on the H100: HBM bytes -- three table rows read (f32:
// 12 bytes) and one row written per element, plus 8 bytes of ids a token;
// the word rows are a gather, each a 3 KB contiguous read at N = 768.
#include "common.cuh"

namespace {

using namespace nbk;

constexpr int ROWS_PER_BLOCK = 8;

template <typename T, int NV>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
    embed_kernel(const int* __restrict__ ids, const int* __restrict__ tids,
                 const T* __restrict__ word, const T* __restrict__ pos,
                 const T* __restrict__ type, const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ out, int M,
                 int seq_len, int vocab, int n_types, float eps) {
  constexpr int N = 128 * NV;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= M) return;
  const int id = ids[row];
  const int tid = tids == nullptr ? 0 : tids[row];
  T* dst = out + (size_t)row * N;
  if (id < 0 || id >= ((vocab + 7) & ~7)) {
    const float q = __int_as_float(0x7fc00000);   // quiet NaN
    const float bad[4] = {q, q, q, q};
#pragma unroll
    for (int i = 0; i < NV; ++i) store4(dst + 4 * (lane + 32 * i), bad);
    return;
  }
  const bool has_w = id < vocab, has_t = tid >= 0 && tid < n_types;
  const T* w = word + (size_t)(has_w ? id : 0) * N;
  const T* p = pos + (size_t)(row % seq_len) * N;
  const T* ty = type + (size_t)(has_t ? tid : 0) * N;
  // rows read unconditionally (row 0 stands in), then scaled by 1 or 0:
  // the loads under the checks ran 6% slower on the H100
  const float kw = has_w ? 1.f : 0.f, kt = has_t ? 1.f : 0.f;

  float v[NV][4];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 4 * (lane + 32 * i);
    const float4 a = load4(w + c), b = load4(p + c), t = load4(ty + c);
    v[i][0] = __fadd_rn(__fadd_rn(__fmul_rn(a.x, kw), b.x),
                        __fmul_rn(t.x, kt));
    v[i][1] = __fadd_rn(__fadd_rn(__fmul_rn(a.y, kw), b.y),
                        __fmul_rn(t.y, kt));
    v[i][2] = __fadd_rn(__fadd_rn(__fmul_rn(a.z, kw), b.z),
                        __fmul_rn(t.z, kt));
    v[i][3] = __fadd_rn(__fadd_rn(__fmul_rn(a.w, kw), b.w),
                        __fmul_rn(t.w, kt));
    sum += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
  }
  const float mean = __fdiv_rn(warp_sum(sum), (float)N);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[i][j] = __fsub_rn(v[i][j], mean);
      sq = __fmaf_rn(v[i][j], v[i][j], sq);
    }
  }
  const float rstd = rsqrtf(__fdiv_rn(warp_sum(sq), (float)N) + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = 4 * (lane + 32 * i);
    const float4 g = load4(scale + c), b = load4(bias + c);
    const float gg[4] = {g.x, g.y, g.z, g.w}, bb[4] = {b.x, b.y, b.z, b.w};
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j], rstd), gg[j]), bb[j]);
    store4(dst + c, o);
  }
}

template <typename T>
int embed(const int* ids, const int* tids, const void* word, const void* pos,
          const void* type, const float* scale, const float* bias, void* out,
          int M, int N, int seq_len, int vocab, int n_types, float eps,
          cudaStream_t st) {
  const int blocks = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  NBK_ROW_WIDTHS(N, embed_kernel<T, NV>
                 <<<blocks, ROWS_PER_BLOCK * 32, 0, st>>>(
                     ids, tids, static_cast<const T*>(word),
                     static_cast<const T*>(pos), static_cast<const T*>(type),
                     scale, bias, static_cast<T*>(out), M, seq_len, vocab,
                     n_types, eps));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (M, N) from ids, tids (M,) int32 (tids may be null: type row 0),
// word (vocab, N), pos (>= seq_len, N), type (n_types, N), all f32 or all
// bf16 (is_f32 = 0); scale, bias (N,) f32; N = 128 * k, k <= 8; M > 0.
int nbk_embed_lookup(const int* ids, const int* tids, const void* word,
                     const void* pos, const void* type, const float* scale,
                     const float* bias, void* out, int M, int N, int seq_len,
                     int vocab, int n_types, float eps, int is_f32,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f32 ? embed<float>(ids, tids, word, pos, type, scale, bias, out,
                               M, N, seq_len, vocab, n_types, eps, st)
                : embed<bf16>(ids, tids, word, pos, type, scale, bias, out,
                              M, N, seq_len, vocab, n_types, eps, st);
}

}  // extern "C"
