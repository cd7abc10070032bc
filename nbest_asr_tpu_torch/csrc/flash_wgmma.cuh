// The pieces the tiled flash kernels' wgmma + TMA instances share at head
// dim 64 (flash_attention.cu's forward, flash_attention_bwd.cu's dQ and
// dK/dV kernels): exp2, the Philox keep bits a warp draws for its own 16
// query rows while its score products run (draw_rows, KeepQ), the
// descriptors of 64 x 64 swizzled tiles, the product with A from
// registers, and, host side, the 3-D tensor map of a (b, s, heads, 64)
// operand.
#pragma once

#include "attention.cuh"
#include "tma.cuh"

namespace nbk {
namespace flash {

using namespace nbk::attn;

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (a result below 2^-126 flushes to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep bits, drawn by the consumer warps: each warp draws the bits of its
// own 16 rows against the tile's 64 columns (256 Philox calls, 8 a lane)
// while the tile's score products run, and hands them to the lanes that
// use them by shuffles.  Bit (jj, e) of a thread's row is its fragment
// column 8 jj + 2 t + e (t = lane % 4).
//
// Query rows (the forward, the dQ kernel): lane 2 r + h draws query row r
// of the warp (Philox row `row`) against keys 8 jj + 4 h .. + 3 of the
// tile (col = the tile's key 4 h): bit 4 jj + i = key 8 jj + 4 h + i.
__device__ __forceinline__ unsigned draw_rows(const DropParams& d, int row,
                                              int col) {
  unsigned w = 0;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const uint4 v = philox_group(d, row, col + 8 * jj);
    w |= (unsigned)(v.x >= d.thresh) << (4 * jj) |
         (unsigned)(v.y >= d.thresh) << (4 * jj + 1) |
         (unsigned)(v.z >= d.thresh) << (4 * jj + 2) |
         (unsigned)(v.w >= d.thresh) << (4 * jj + 3);
  }
  return w;
}

// The rows g and g + 8 of a thread, from the lanes that drew them.
template <bool DROP>
struct KeepQ {
  unsigned a = 0, b = 0;
  __device__ __forceinline__ KeepQ(unsigned w, int lane) {
    if (!DROP) return;
    const int g = lane >> 2, t4 = lane & 3;
    a = __shfl_sync(0xffffffffu, w, 2 * g + (t4 >> 1)) >> (2 * (t4 & 1));
    b = __shfl_sync(0xffffffffu, w, 2 * g + 16 + (t4 >> 1)) >>
        (2 * (t4 & 1));
  }
  // the bit of fragment row half `hi` (row g + 8 hi), column 8 jj + 2 t + e
  __device__ __forceinline__ bool operator()(bool hi, int jj, int e) const {
    return ((hi ? b : a) >> (4 * jj + e)) & 1u;
  }
};

// Descriptors of 64 x 64 swizzled tiles (wgmma.cuh), built once and
// offset: the start address is the low field in 16-byte units, and no
// offset here carries out of it.  K-major (a k-step 32 bytes along the
// rows) or MN-major (a k-step 16 rows, 2048 bytes).
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile) {
  return smem_desc(tile, 1, 64);
}
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile) {
  return smem_desc(tile, 512, 64);
}
constexpr uint64_t KSTEP = 32 >> 4, MNSTEP = 2048 >> 4,
                   TILE_DESC = QTILE >> 4;

// acc += A (64 x 64: sixteen bf16 A fragments, four k-steps) . B, B the
// tile of MN-major descriptor db.
__device__ __forceinline__ void issue_rs(float (&acc)[32],
                                         const unsigned (&a)[16],
                                         uint64_t db) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs_n64(acc, a + 4 * j, db + j * MNSTEP, 1);
}

// The 3-D tensor map of a (b, s, heads, 64) operand's rows (ld values
// apart): (head column, row, element) in 64 x 64 x 1 boxes, so a box
// reaching past s is zero-filled within its element.
inline int rows_map(CUtensorMap* m, const void* p, int ld, int n_heads,
                    int S, int B) {
  return encode<3>(m, false, p,
                   {(cuuint64_t)n_heads * WD, (cuuint64_t)S, (cuuint64_t)B},
                   {(cuuint64_t)ld * 2, (cuuint64_t)S * ld * 2},
                   {(cuuint32_t)WD, (cuuint32_t)QT, 1u});
}

}  // namespace flash
}  // namespace nbk
