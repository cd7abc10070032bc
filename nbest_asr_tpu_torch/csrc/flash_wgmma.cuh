// The pieces the tiled flash kernels' wgmma + TMA instances share
// (flash_attention.cu's forward, flash_attention_bwd.cu's dQ and dK/dV
// kernels, each at head dims 64 and 96): exp2, the Philox keep bits a warp
// draws for its own 16 query rows while its score products run
// (draw_rows, KeepQ), the descriptors of 64-row swizzled panels (64
// columns, 128-byte swizzle; 32 columns, 64-byte swizzle), the products
// with A from registers, the 96-column tiles (two panels, each filled by
// its own TMA map; their products and stores), and, host side, the 3-D
// tensor maps of a (b, s, heads, d) operand's panels.
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

// The same built where they are used, from a panel's 32-bit shared
// address a (bytes): the fields a descriptor's kind fixes | a / 16.  The
// 96-column kernels take them so: twelve 64-bit descriptors held across
// a tile loop would take 24 registers a thread, and the dK/dV kernel
// spilled with them.  Kinds: a 64-column panel K-major or MN-major
// (128-byte swizzle, as kmajor, mnmajor), a 32-column panel either way
// (64-byte swizzle: 8-row groups 512 bytes apart; an MN-major k-step is
// 16 rows, 1024 bytes).
constexpr uint64_t KMAJOR128 = (1ull << 16) | (64ull << 32) | (1ull << 62);
constexpr uint64_t MNMAJOR128 = (512ull << 16) | (64ull << 32) | (1ull << 62);
constexpr uint64_t PANEL64 = (1ull << 16) | (32ull << 32) | (2ull << 62);
template <uint64_t KIND>
__device__ __forceinline__ uint64_t desc_at(unsigned a) {
  return KIND | (a >> 4);
}

// acc += A (64 x 64: sixteen bf16 A fragments, four k-steps) . B, B the
// tile of MN-major descriptor db.
__device__ __forceinline__ void issue_rs(float (&acc)[32],
                                         const unsigned (&a)[16],
                                         uint64_t db) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs_n64(acc, a + 4 * j, db + j * MNSTEP, 1);
}

// acc (64 x 32) += A (as above) . B, B the 32-column panel at shared
// address b, MN-major (64-byte swizzle).
__device__ __forceinline__ void issue_rs(float (&acc)[16],
                                         const unsigned (&a)[16],
                                         unsigned b) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs_n32(acc, a + 4 * j, desc_at<PANEL64>(b + j * 1024), 1);
}

// 96-column tiles (head dim 96), laid out as the single-block d = 96 pair
// lays them (attention.cuh): a 64-row tile is columns 0-63
// 128-byte-swizzled (8 KB), then columns 64-95 64-byte-swizzled (4 KB),
// each panel arriving through its own tensor map (boxes of 64 and 32
// columns).  Products over a row take 4 k16 steps on panel 0 and 2 on
// panel 1; products into 96 columns, an m64n64 and an m64n32 one.  The
// descriptors are built at each use from 32-bit shared addresses
// (desc_at): the twelve a kernel would hold spilled the dK/dV kernel.
constexpr int T96 = QTILE + QTILE / 2;  // bytes of a 64-row tile

// The two panels' tensor maps of one operand (boxes of 64 and 32 columns).
struct PanelMaps {
  CUtensorMap p0, p1;
};

// TMA of rows row .. + 63 of a head's 96 columns (from column col) into
// the tile at dst, completing on bar.
__device__ __forceinline__ void tma_tile96(unsigned char* dst,
                                           const PanelMaps& m, uint64_t* bar,
                                           int col, int row, int elem) {
  tma_load(dst, &m.p0, bar, col, row, elem);
  tma_load(dst + QTILE, &m.p1, bar, col + WD, row, elem);
}

// a, made opaque to the compiler, so that the descriptors built from a
// tile's address in a loop are built at each use instead of hoisted and
// held (attention.cuh's fresh, on a 32-bit shared address).
__device__ __forceinline__ unsigned opaque(unsigned a) {
  asm volatile("" : "+r"(a));
  return a;
}

// acc (64 x 64) = A . B^T over 96 columns, A and B the K-major tiles at
// shared addresses a and b: panel 0's four k16 steps (32 bytes along its
// rows), then panel 1's two.
__device__ __forceinline__ void issue_nt96(float (&acc)[32], unsigned a,
                                           unsigned b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64(acc, desc_at<KMAJOR128>(a + kk * 32),
                 desc_at<KMAJOR128>(b + kk * 32), kk);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_ss_n64(acc, desc_at<PANEL64>(a + QTILE + kk * 32),
                 desc_at<PANEL64>(b + QTILE + kk * 32), 1);
}

// (acc, acc1) (64 x 96) += A (64 x 64, sixteen bf16 A fragments) . B, B
// the tile at shared address b read MN-major: panel 0's columns into acc
// (m64n64k16), panel 1's into acc1 (m64n32k16), four k16 steps each.
__device__ __forceinline__ void issue_rs96(float (&acc)[32],
                                           float (&acc1)[16],
                                           const unsigned (&a)[16],
                                           unsigned b) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs_n64(acc, a + 4 * j, desc_at<MNMAJOR128>(b + j * 2048), 1);
  issue_rs(acc1, a, b + QTILE);
}

// Stores the fragment row half `hi` (row g + 8 hi) of a 96-column sum (c0:
// columns 0-63, c1: 64-95) as bf16 at out + r + col.
__device__ __forceinline__ void store96(bf16* out, size_t r, int col,
                                        int t4, bool hi, const float* c0,
                                        const float* c1) {
  const int e = hi ? 2 : 0;
#pragma unroll
  for (int jj = 0; jj < 12; ++jj) {
    const float* c = jj < 8 ? c0 + 4 * jj : c1 + 4 * (jj - 8);
    *reinterpret_cast<unsigned*>(out + r + col + jj * 8 + 2 * t4) =
        pack_bf16x2(c[e], c[e + 1]);
  }
}

// The 3-D tensor map of a (b, s, heads, D) operand's rows (ld values
// apart): (head column, row, element) in box x 64 x 1 boxes, so a box
// reaching past s is zero-filled within its element.  A box is one
// swizzled panel: 64 columns (128-byte swizzle) or, the last 32 of a
// 96-column head, 32 (64-byte swizzle).
inline int rows_map(CUtensorMap* m, const void* p, int ld, int n_heads,
                    int S, int B, int D = WD, int box = WD) {
  return encode<3>(m, false, p,
                   {(cuuint64_t)n_heads * D, (cuuint64_t)S, (cuuint64_t)B},
                   {(cuuint64_t)ld * 2, (cuuint64_t)S * ld * 2},
                   {(cuuint32_t)box, (cuuint32_t)QT, 1u},
                   box == WD ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B);
}

// The two panels' maps of a (b, s, heads, 96) operand with row stride ld.
inline int panel_maps(PanelMaps* m, const void* p, int ld, int n_heads,
                      int S, int B) {
  const int rc = rows_map(&m->p0, p, ld, n_heads, S, B, 96);
  return rc != 0 ? rc : rows_map(&m->p1, p, ld, n_heads, S, B, 96, 32);
}

}  // namespace flash
}  // namespace nbk
