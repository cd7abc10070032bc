// Counter-based Philox4x32-10 dropout bits, the CUDA twin of
// nbest_asr_tpu_torch/ops/philox.py (the plain version and the scheme's
// description).  Replaces the TPU hardware PRNG of the Pallas kernels'
// dropout (nbest_asr_tpu/ops/flash_attention.py:56 _keep_mask,
// ops/fused_ffn.py:106 _mask_ids, :137 _drop): every element's bits are
// keyed on (seed, stream, absolute row, column), so a kernel's tiling never
// changes its mask and a backward kernel regenerates the forward's mask.
//
//   key     = (seed_lo, seed_hi)
//   counter = (col >> 2, row, stream, 0)
//   bits    = word (col & 3) of Philox4x32-10(counter, key)
//   keep    = bits >= thresh,  thresh = min(int(rate * 2^32), 2^32 - 1)
//
// Cost: one Philox call (10 rounds, two mul.hi each) per four columns of
// a row; each caller computes it once per pair or quad of columns it owns.
#pragma once

#include <stdint.h>

namespace nbk {

struct DropParams {
  unsigned seed_lo, seed_hi, stream, thresh;
  float inv_keep;  // f32(1 / (1 - rate)), the TPU kernels' multiplier
  int on;          // 0: no dropout (rate 0)
};

// The kernel arguments of a dropout site, from the C interface's scalars.
inline DropParams make_drop(unsigned long long seed, int stream,
                            unsigned thresh, float inv_keep, int on) {
  DropParams d;
  d.seed_lo = (unsigned)(seed & 0xFFFFFFFFull);
  d.seed_hi = (unsigned)(seed >> 32);
  d.stream = (unsigned)stream;
  d.thresh = thresh;
  d.inv_keep = inv_keep;
  d.on = on;
  return d;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The four words of column group col >> 2 of ``row``.
__device__ __forceinline__ uint4 philox_group(const DropParams& d, int row,
                                              int col) {
  return philox4x32_10(
      make_uint4((unsigned)col >> 2, (unsigned)row, d.stream, 0u), d.seed_lo,
      d.seed_hi);
}

__device__ __forceinline__ unsigned philox_word(uint4 w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// Dropout of one value with its bits: v * inv_keep kept, 0 dropped.
__device__ __forceinline__ float drop_value(const DropParams& d, float v,
                                            unsigned bits) {
  return bits >= d.thresh ? __fmul_rn(v, d.inv_keep) : 0.f;
}

}  // namespace nbk
