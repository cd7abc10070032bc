// Hopper GEMMs with fused epilogues: every bf16 weight product of an
// encoder layer, forward and backward -- the forwards' bias / GELU / dropout
// products (gemm_bias_act), the residual forwards (gemm_bias_residual) and
// the backwards' dgrads (gemm_dgrad) -- and every int8 product of the int8
// serving and training routes (gemm_i8_bias_act, gemm_i8_bias_residual and
// the int8 dgrads gemm_i8_dgrad).
//
// Replaces the in-kernel GEMMs of the TPU megakernels:
//   nbest_asr_tpu/ops/fused_attention.py:_fab_fwd_kernel (:152)
//     - `_qkv_gemm` (:143)                         -> gemm_bias_act, bias
//     - out-proj `ctx @ wo + bo` (:182)            -> gemm_bias_residual
//   nbest_asr_tpu/ops/fused_ffn.py:_fwd_kernel (:166)
//     - `_gelu_slice` (:153-164)                   -> gemm_bias_act, gelu:
//                                                     dropout 1, h saved
//     - `gd @ w2 + b2` (:181-191)                  -> gemm_bias_residual,
//                                                     dropout 2, y2d saved
//   nbest_asr_tpu/ops/fused_ffn.py:_bwd_kernel (:224)
//     - `dy2 @ w2^T`, drop 1, * gelu'(h) (:245-253) -> gemm_dgrad dgelu
//     - `ds + dh @ w1^T` (:239, :251, :258)          -> gemm_dgrad residual
//   nbest_asr_tpu/ops/fused_attention.py:_fab_bwd_kernel (:204)
//     - dctx = `dout @ wo^T` (:232, bf16 per head :243) -> gemm_dgrad none
//     - `ds + dqkv @ wqkv^T` (:268-269)                 -> gemm_dgrad residual
// (the int8 route's bf16-backward recompute of h and qkv runs
// gemm_bias_act too), and, in s8, `_dense_i8` / `_dot_i8`
// (nbest_asr_tpu/ops/int8_serving.py:66-79) and `_dense_i8_f32`
// (fused_ffn.py:394) in
//   int8_serving.py:_attn_i8_kernel (:157), QKV (:168) -> gemm_i8_bias_act
//     - out-proj (:191-193)                    -> gemm_i8_bias_residual
//   int8_serving.py:_ffn_i8_kernel (:90), W1 + GELU (:94-95)
//                                              -> gemm_i8_bias_act, gelu
//     - W2 (:96-97)                            -> gemm_i8_bias_residual
//   fused_ffn.py:_fwd_kernel_i8 (:404), W1, GELU, drop 1, h (:417-422)
//                                              -> gemm_i8_bias_act, gelu
//     - W2, bf16, drop 2, y2d (:424-431)       -> gemm_i8_bias_residual,
//                                                 y2d saved
//   fused_attention.py:_fab_fwd_kernel_i8 (:436), QKV (:454-455)
//                                              -> gemm_i8_bias_act
//     - out-proj, bf16, hidden drop, od (:471-478)
//                                              -> gemm_i8_bias_residual,
//                                                 od saved
// and the `_dgrad_rows_i8` products (fused_ffn.py:523-530) of
//   fused_ffn.py:_bwd_kernel_i8 (:533)
//     - dgd = dy2 @ W2^T, drop 1, * gelu'(h) (:562-566) -> gemm_i8_dgrad dgelu
//     - ds + dh @ W1^T (:548, :568, :575)               -> gemm_i8_dgrad
//                                                          residual
//   fused_attention.py:_fab_bwd_kernel_i8 (:565)
//     - dctx = dout @ Wo^T (:597, bf16 per head :609)   -> gemm_i8_dgrad none
//     - ds + dqkv @ Wqkv^T (:633-635)                   -> gemm_i8_dgrad
//                                                          residual
//
// What bounds each launch on the H100 (chip_smoke.train_layer_bounds): at
// BERT-base shapes (M = 8192 rows, N, K in {768, 2304, 3072}) the QKV
// product, the residual GEMMs and the residual / none dgrads sit far above
// the bf16 ridge (~295 flop/byte), so the tensor cores' rate bounds them.
// The two GELU launches sit near it or below: the forward W1 product (N =
// 3072, K = 768) writes h and g, 2 x 50 MB beside 39 GFLOP (0.035 ms of
// bytes against 0.039 ms of operations at 8192 rows); the dgelu dgrad
// reads h and writes dh and gd, 150 MB against 39 GFLOP, and is bound by
// bytes.  Both carry an erff (and the dgrad an expf) and, in training, a
// Philox call per four elements, so their epilogues set their time.  In
// s8 the tensor cores run twice as fast and the operands are half the
// bytes, so at 8192 rows every int8 training launch is bound by the bytes
// of its epilogue (the dgelu dgrad writes dh in bf16 and f32 and gd: 250
// MB at N = 3072; a residual launch reads resid and writes the f32 sum and
// y2d, 50 MB at N = 768); the serving launches at 16384 rows by operations.
//
// Design, for all: a persistent grid (one block per SM) walks the 192 x
// 128 output tiles, n fastest, so the blocks in flight share A's row
// panels in L2.  Four warpgroups: warpgroup 0 is the producer -- one
// thread issues TMA loads (cp.async.bulk.tensor, 128-byte swizzle, 128
// bytes deep: 64 bf16 or 128 s8) of the A and B tiles into a ring of
// STAGES slots, each with a full and an empty mbarrier -- and gives its
// registers up (setmaxnreg) to warpgroups 1-3, the consumers, which own 64
// rows x 128 each and run wgmma m64n128k16 (bf16 in, f32 accumulate) or
// m64n128k32 (s8 in, s32 accumulate) from shared memory, one k-block in
// flight.  A tile row is 128 bytes in either type and a k-step 32 bytes,
// so the ring, the swizzle and the descriptors are the same in bytes.
// Rows past M and depth past K are zero-filled by TMA (N % 128 == 0, the
// wrappers' contract, so no tile straddles N; K needs only the 16-byte row
// pitch TMA takes; an int8 K = 64 * odd half-fills its last stage).  The
// producer runs ahead into the next tile while the consumers run this
// tile's epilogue; each consumer thread loads its epilogue operands (bias,
// w_scale, h, ds, resid; the residual epilogues' bias at use) three
// passes ahead, the first during the mainloop.  What sets the dgelu
// launch's time is its epilogue (erff, expf, Philox per element),
// latency-bound on the consumer warps: three consumer warpgroups (192 x
// 128 tiles) beat two (128 x 192), and ping-pong warpgroups (one's
// epilogue beside the other's mainloop) ran 2-8% slower, the epilogue on
// half the warps (PERF.md, Findings).
// B's layout: the dgrads multiply by w^T with w (N, K) row-major --
// K-major B, wgmma's own -- and the bf16 forwards by w (K, N) row-major --
// MN-major B, the instruction's transpose-B -- so no transposed copy of a
// weight is ever made.  For 8-bit types wgmma has no transpose, so both
// s8 operands are K-major: the int8 forwards' weight is (K, N) stored
// column-major (quant.kernel_layout), the int8 dgrads' the (in, out)
// weight row-major (N = in, K = out).
//
// Epilogue: each warp stages its 16 x 64 f32 accumulator chunks through
// shared memory and reads them back row-contiguous, eight columns a lane,
// so that every operand load and output store is a 16-byte access.  An s8
// accumulator is converted once (__int2float_rn) and multiplied by its
// row's scale (x_scale, or the dgrads' g_scale) as it is staged.  The
// numerics are those of the TPU kernels (__fmul_rn / __fadd_rn where nvcc
// could contract):
//   bias      : out = bf16(acc + bias); s8: bf16(((f32(acc) * xs) * ws) +
//               bias), ws the weight's per-output-channel scale
//   gelu      : h = bf16(acc + bias) (s8: as bias); [h saved]; g =
//               gelu(f32 h) in f32 with the exact erff (not the TPU's A&S
//               polynomial); g = drop1(g) (times f32(1/keep)); store
//               bf16(g)
//   residual  : y2 = f32(bf16(acc + bias)) (s8: the dequant as bias);
//               y2 = drop2(y2); [bf16(y2) saved as y2d]; store y2 +
//               f32(resid) as f32 (the input of layer_norm.cu) -- the sum
//               uses the unrounded f32 y2
//   dgelu     : d = drop1(acc) (s8: drop1(f32(acc) * g_scale)); dh = d *
//               gelu'(f32 h), stored in bf16 (and, s8, in f32: the next
//               gradient quant's input); [gd = bf16(drop1(gelu(f32 h)))
//               regenerated and saved for dW2]
//   dx        : bf16(ds + acc), ds the f32 residual-branch gradient
//   dnone     : bf16(acc)
// gelu and dgelu share one function for drop1(gelu(h)) (gelu_dropped), so
// the backward's gd is the forward's g bit for bit.  Dropout bits are
// Philox keyed on absolute (row, column) (philox.cuh), one call per four
// columns, so every mask equals the forward's bit for bit.  The integer
// dot is exact in any order (|acc| <= 127^2 K < 2^31), so the s8 launches
// equal their plain versions bit for bit, up to erff / expf in the GELU
// epilogues.  TRAIN compiles in the Philox dropout and the saved outputs:
// the int8 serving GELU and residual instances are built without them
// (compiled in, they cost an earlier mma.sync int8 GEMM's serving launches
// 13-40%).
#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "philox.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using namespace nbk;

// A 192 x 128 output tile: three consumer warpgroups of 64 rows each and
// the producer's (512 threads).  Measured against 128 x 192 with two
// consumer warpgroups (the epilogue on 8 warps instead of 12), it was 2-12%
// faster for every launch of a BERT-base layer.
constexpr int BM = 192, BN = 128;
constexpr int ROW = 128;  // bytes of a tile row: 64 bf16 or 128 s8, the
                          // swizzle's width
constexpr int WGS = BM / 64, THREADS = 128 * (WGS + 1);
constexpr int REGS = 152;  // per consumer thread after setmaxnreg: the
                           // producer's 128 x 40 plus 384 x 152 fit 64 K
constexpr int EPI_LD = 72;               // staging row stride, floats
constexpr int EPI_WARP = 16 * EPI_LD;    // staging floats per consumer warp
constexpr int A_BYTES = BM * ROW, B_BYTES = BN * ROW;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int STAGES = 4;
// 1024-byte alignment slack, the ring, the staging, 2 barriers a slot:
// 220,224 bytes of the 232,448 a block may have
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 4 * WGS * EPI_WARP * 4 +
                     2 * STAGES * 8;
static_assert(SMEM <= 232448, "shared memory");

// depth of a k-block in elements: one 128-byte tile row
template <bool S8>
__host__ __device__ constexpr int bk() {
  return S8 ? ROW : ROW / 2;
}

enum {
  EPI_RESIDUAL = 0,
  EPI_DGELU = 1,
  EPI_DX = 2,
  EPI_DNONE = 3,
  EPI_BIAS = 4,
  EPI_GELU = 5
};

// B = w (K, N) row-major (the bf16 forwards) rather than w (N, K) (the
// dgrads, and every s8 product: 8-bit wgmma has no transpose)
template <bool S8, int EPI>
__host__ __device__ constexpr bool mn_b() {
  return !S8 && (EPI == EPI_RESIDUAL || EPI == EPI_BIAS || EPI == EPI_GELU);
}

// --- wgmma ------------------------------------------------------------ //

// d (64 x N f32, the m64nNk16 fragment) += A (64 x 16, K-major) * B (16 x
// N; K-major, or MN-major with TRANS_B = 1).  Fragment: thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns
// 8 j + 2 (t % 4) (+ 1) in d[4 j ..], as mma.sync's C fragment.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

// d (64 x N s32, the same fragment) += A (64 x 32 s8, K-major) * B (32 x N
// s8, K-major): 8-bit wgmma takes no transpose or scale operands.
__device__ __forceinline__ void wgmma_n128_s8(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// An accumulator as the epilogue's f32: a bf16 product's as it is, an s8
// product's converted once and times its row's scale.
__device__ __forceinline__ float to_f32(float acc, float) { return acc; }
__device__ __forceinline__ float to_f32(int acc, float row_scale) {
  return __fmul_rn(__int2float_rn(acc), row_scale);
}

// --- epilogue ---------------------------------------------------------- //

// Eight bf16 (16 bytes) as f32: a bf16 is the high half of its f32.
__device__ __forceinline__ void unpack8(const uint4 u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                 pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// The dropout bits of columns col .. col + 7 (col % 8 == 0) of `row`.
__device__ __forceinline__ void drop_bits8(const DropParams& d, int row,
                                           int col, unsigned (&bits)[8]) {
  const uint4 w0 = philox_group(d, row, col);
  const uint4 w1 = philox_group(d, row, col + 4);
  bits[0] = w0.x, bits[1] = w0.y, bits[2] = w0.z, bits[3] = w0.w;
  bits[4] = w1.x, bits[5] = w1.y, bits[6] = w1.z, bits[7] = w1.w;
}

// drop1(gelu(h)) in f32 from h and e = gelu_erf(h): the forward's g and
// the dgelu epilogue's regenerated gd, one function so that they agree bit
// for bit.
__device__ __forceinline__ float gelu_dropped(const DropParams& drop,
                                              bool dropping, float h,
                                              float e, unsigned bits) {
  const float g = gelu_f32(h, e);
  return dropping ? drop_value(drop, g, bits) : g;
}

// An epilogue operand's eight columns of a row -- resid or h (16 bytes of
// bf16 in x), or ds or, for the bias and gelu epilogues, the bias (32
// bytes of f32 in x, y) and, in s8, the weight scales (z, w); the s8
// residual epilogue's resid in x and weight scales in y, z -- loaded
// passes ahead of use.  (The residual epilogues load their bias at use:
// prefetched too, it cost the s8 training instance a spill.)
struct Opnd {
  uint4 x, y, z, w;
};

template <bool S8, int EPI>
__device__ __forceinline__ Opnd load_opnd(const float* __restrict__ bias,
                                          const float* __restrict__ ws,
                                          const bf16* __restrict__ resid,
                                          const bf16* __restrict__ h,
                                          const float* __restrict__ ds,
                                          size_t off, int col) {
  Opnd o = {};
  if (EPI == EPI_BIAS || EPI == EPI_GELU) {
    o.x = *reinterpret_cast<const uint4*>(bias + col);
    o.y = *reinterpret_cast<const uint4*>(bias + col + 4);
    if (S8) {
      o.z = *reinterpret_cast<const uint4*>(ws + col);
      o.w = *reinterpret_cast<const uint4*>(ws + col + 4);
    }
  }
  if (EPI == EPI_RESIDUAL) {
    o.x = *reinterpret_cast<const uint4*>(resid + off);
    if (S8) {
      o.y = *reinterpret_cast<const uint4*>(ws + col);
      o.z = *reinterpret_cast<const uint4*>(ws + col + 4);
    }
  }
  if (EPI == EPI_DGELU) o.x = *reinterpret_cast<const uint4*>(h + off);
  if (EPI == EPI_DX) {
    o.x = *reinterpret_cast<const uint4*>(ds + off);
    o.y = *reinterpret_cast<const uint4*>(ds + off + 4);
  }
  return o;
}

__device__ __forceinline__ void floats8(const uint4 a, const uint4 b,
                                        float (&f)[8]) {
  f[0] = __uint_as_float(a.x), f[1] = __uint_as_float(a.y);
  f[2] = __uint_as_float(a.z), f[3] = __uint_as_float(a.w);
  f[4] = __uint_as_float(b.x), f[5] = __uint_as_float(b.y);
  f[6] = __uint_as_float(b.z), f[7] = __uint_as_float(b.w);
}

// Eight consecutive outputs (row, col .. col + 7) from their f32 sums v
// (an s8 product's already times its row's scale) and the operand o.
// Without TRAIN the dropout and the saved outputs (aux) are compiled out.
template <bool S8, int EPI, bool TRAIN>
__device__ __forceinline__ void epilogue8(const float* __restrict__ bias,
                                          bf16* __restrict__ out_bf,
                                          float* __restrict__ out_f,
                                          bf16* __restrict__ aux,
                                          const DropParams& drop, int row,
                                          int col, int N, const Opnd& o,
                                          float (&v)[8]) {
  const size_t off = (size_t)row * N + col;
  const bool dropping = TRAIN && drop.on;
  unsigned bits[8];
  if ((EPI == EPI_GELU || EPI == EPI_RESIDUAL || EPI == EPI_DGELU) &&
      dropping)
    drop_bits8(drop, row, col, bits);
  if (EPI == EPI_DNONE) {
    store8(out_bf + off, v);
  } else if (EPI == EPI_DX) {
    float r[8];
    floats8(o.x, o.y, r);  // ds
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(r[i], v[i]);
    store8(out_bf + off, v);
  } else if (EPI == EPI_DGELU) {
    float hf[8], g[8];
    unpack8(o.x, hf);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = gelu_erf(hf[i]);  // one erff for gelu' and gelu
      const float d = dropping ? drop_value(drop, v[i], bits[i]) : v[i];
      v[i] = __fmul_rn(d, gelu_grad_f32(hf[i], e));
      g[i] = gelu_dropped(drop, dropping, hf[i], e, bits[i]);
    }
    store8(out_bf + off, v);
    if (S8 && out_f) {  // dh in f32, the next gradient quant's input
      *reinterpret_cast<float4*>(out_f + off) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(out_f + off + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
    if (TRAIN && aux) store8(aux + off, g);
  } else if (EPI == EPI_BIAS || EPI == EPI_GELU) {
    float b[8];
    floats8(o.x, o.y, b);
    if (S8) {  // ((f32(acc) * xs) * ws) + bias
      float w[8];
      floats8(o.z, o.w, w);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __fmul_rn(v[i], w[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = round_bf16(v[i] + b[i]);
    if (EPI == EPI_GELU) {
      if (TRAIN && aux) store8(aux + off, v);  // h, bf16-exact already
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = gelu_dropped(drop, dropping, v[i], gelu_erf(v[i]), bits[i]);
    }
    store8(out_bf + off, v);
  } else {  // EPI_RESIDUAL
    float b[8], x[8];
    load8(bias + col, b);
    if (S8) {  // ((f32(acc) * xs) * ws) + bias
      float w[8];
      floats8(o.y, o.z, w);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __fmul_rn(v[i], w[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = round_bf16(__fadd_rn(v[i], b[i]));
      if (dropping) v[i] = drop_value(drop, v[i], bits[i]);
    }
    if (TRAIN && aux) store8(aux + off, v);
    unpack8(o.x, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], x[i]);
    *reinterpret_cast<float4*>(out_f + off) =
        make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(out_f + off + 4) =
        make_float4(v[4], v[5], v[6], v[7]);
  }
}

// --- the kernel -------------------------------------------------------- //

// S8: s8 operands and s32 accumulators (x_scale / w_scale the int8
// products' row and column scales), else bf16 and f32.
template <bool S8, int EPI, bool TRAIN>
__global__ void __launch_bounds__(THREADS, 1) gemm_tma_kernel(
    const __grid_constant__ CUtensorMap tma_a,
    const __grid_constant__ CUtensorMap tma_b, const float* __restrict__ bias,
    const float* __restrict__ x_scale, const float* __restrict__ w_scale,
    const bf16* __restrict__ resid, const bf16* __restrict__ h,
    const float* __restrict__ ds, bf16* __restrict__ out_bf,
    float* __restrict__ out_f, bf16* __restrict__ aux, const DropParams drop,
    int M, int N, int K) {
  constexpr bool MN_B = mn_b<S8, EPI>();
  constexpr int BK = bk<S8>();
  using Acc = typename std::conditional<S8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 128-byte swizzled tiles need 1024-byte aligned bases
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sA = base;
  unsigned char* sB = base + STAGES * A_BYTES;
  float* sC = reinterpret_cast<float*>(base + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(sC + 4 * WGS * EPI_WARP);
  uint64_t* empty = full + STAGES;

  const int tiles_n = N / BN;  // N % 128 == 0: no tile straddles N
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int kblocks = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], 4 * WGS);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      unsigned phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * BM, n0 = t % tiles_n * BN;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* a = sA + stage * A_BYTES;
          unsigned char* b = sB + stage * B_BYTES;
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          tma_load(a, &tma_a, &full[stage], kb * BK, m0);
          if (MN_B) {  // two 64-column boxes of w (K, N)
            tma_load(b, &tma_b, &full[stage], n0, kb * BK);
            tma_load(b + BK * ROW, &tma_b, &full[stage], n0 + 64, kb * BK);
          } else {
            tma_load(b, &tma_b, &full[stage], kb * BK, n0);
          }
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // consumers: warpgroup w (1 ..) owns rows 64 (w - 1) .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
    const int lane = threadIdx.x & 31, cw = threadIdx.x / 32 - 4;
    float* st = sC + cw * EPI_WARP;
    Acc acc[BN / 2];
    int stage = 0;
    unsigned phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * BM, n0 = t % tiles_n * BN;
      // Epilogue pass q (0 .. PASSES - 1) covers 4 rows x 64 columns of the
      // warp's 16 rows: lane l takes row (q % 4) * 4 + l / 8 and columns
      // (q / 4) * 64 + (l % 8) * 8 .. + 7.  Its operand is loaded three
      // passes ahead; the first three load during the mainloop.
      constexpr int PASSES = BN / 64 * 4;
      const int row0 = m0 + (wg - 1) * 64 + (cw & 3) * 16 + (lane >> 3);
      const int col0 = n0 + (lane & 7) * 8;
      auto prefetch = [&](int q) {
        const int row = row0 + (q & 3) * 4, col = col0 + (q >> 2) * 64;
        return EPI != EPI_DNONE && q < PASSES && row < M
                   ? load_opnd<S8, EPI>(bias, w_scale, resid, h, ds,
                                        (size_t)row * N + col, col)
                   : Opnd{};
      };
      Opnd o0 = prefetch(0), o1 = prefetch(1), o2 = prefetch(2);
      // s8: the scales of the two rows (g, g + 8 of the warp's 16) this
      // thread's accumulators hold
      float rs0 = 1.f, rs1 = 1.f;
      if (S8) {
        const int r = m0 + (wg - 1) * 64 + (cw & 3) * 16 + (lane >> 2);
        rs0 = r < M ? x_scale[r] : 0.f;
        rs1 = r + 8 < M ? x_scale[r + 8] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = 0;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&full[stage], phase);
        const unsigned char* a = sA + stage * A_BYTES + (wg - 1) * 64 * ROW;
        const unsigned char* b = sB + stage * B_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // K-major: a k-step (k16 bf16, k32 s8) is 32 bytes along the
          // swizzled 128-byte row, 8-row groups 1024 bytes apart.  MN-major
          // B: 16 k-rows of 128 bytes, 64-column boxes 8192 bytes apart.
          const uint64_t da = smem_desc(a + kk * 32, 1, 64);
          const uint64_t db = MN_B ? smem_desc(b + kk * 16 * ROW, 512, 64)
                                   : smem_desc(b + kk * 32, 1, 64);
          if constexpr (S8)
            wgmma_n128_s8(acc, da, db);
          else
            wgmma_n128<MN_B ? 1 : 0>(acc, da, db);
        }
        wgmma_commit();
        fence_acc(acc);
        if (kb > 0) {  // the previous k-block's products are done
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[prev]);
      fence_acc(acc);

      // epilogue, 64 columns at a time through this warp's staging rows
      const int g = lane >> 2, t4 = lane & 3;
      const int hs = (lane >> 2) & 1;  // read order: no bank conflicts
#pragma unroll
      for (int c = 0; c < BN / 64; ++c) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = c * 8 + jj;
          *reinterpret_cast<float2*>(st + g * EPI_LD + jj * 8 + 2 * t4) =
              make_float2(to_f32(acc[4 * j], rs0),
                          to_f32(acc[4 * j + 1], rs0));
          *reinterpret_cast<float2*>(st + (g + 8) * EPI_LD + jj * 8 +
                                     2 * t4) =
              make_float2(to_f32(acc[4 * j + 2], rs1),
                          to_f32(acc[4 * j + 3], rs1));
        }
        __syncwarp();
        // one copy of the epilogue's code per 64 columns: unrolled, the
        // passes overflowed the instruction cache (dgelu 1.2-2.4x slower)
#pragma unroll 1
        for (int p = 0; p < 4; ++p) {
          const int q = c * 4 + p;
          const Opnd o = o0;
          o0 = o1;
          o1 = o2;
          o2 = prefetch(q + 3);
          const float* sv = st + (p * 4 + (lane >> 3)) * EPI_LD +
                            (lane & 7) * 8;
          const float4 x = *reinterpret_cast<const float4*>(sv + 4 * hs);
          const float4 y = *reinterpret_cast<const float4*>(sv + 4 - 4 * hs);
          const float4 lo = hs ? y : x, hi = hs ? x : y;
          float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
          const int row = row0 + p * 4, col = col0 + c * 64;
          if (row < M)
            epilogue8<S8, EPI, TRAIN>(bias, out_bf, out_f, aux, drop, row,
                                      col, N, o, v);
        }
        __syncwarp();
      }
    }
  }
}

// --- host side --------------------------------------------------------- //

// A tensor map of a row-major (outer, inner) bf16 or s8 matrix, box
// (box_outer, 128 bytes: the swizzle's width).
template <bool S8>
int encode2(CUtensorMap* map, const void* ptr, int inner, int outer,
            int box_outer) {
  return encode<2>(map, S8, ptr, {(cuuint64_t)inner, (cuuint64_t)outer},
                   {(cuuint64_t)inner * (S8 ? 1 : 2)},
                   {(cuuint32_t)bk<S8>(), (cuuint32_t)box_outer});
}

struct Operands {
  const float* bias;
  const float* x_scale;
  const float* w_scale;
  const bf16* resid;
  const bf16* h;
  const float* ds;
  bf16* out_bf;
  float* out_f;
  bf16* aux;
};

template <bool S8, int EPI, bool TRAIN = true>
int launch(const void* a, const void* w, const Operands& o,
           const DropParams& drop, int M, int N, int K, cudaStream_t s) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_tma_kernel<S8, EPI, TRAIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap ta, tb;
  int rc = encode2<S8>(&ta, a, K, M, BM);
  if (rc == 0)  // w (K, N) in 64-column boxes BK deep, or w (N, K) in BN-row
                // boxes 128 bytes deep
    rc = mn_b<S8, EPI>() ? encode2<S8>(&tb, w, N, K, bk<S8>())
                         : encode2<S8>(&tb, w, K, N, BN);
  if (rc != 0) return rc;
  const int tiles = (M + BM - 1) / BM * (N / BN);
  gemm_tma_kernel<S8, EPI, TRAIN>
      <<<std::min(tiles, sm_count()), THREADS, SMEM, s>>>(
          ta, tb, o.bias, o.x_scale, o.w_scale, o.resid, o.h, o.ds, o.out_bf,
          o.out_f, o.aux, drop, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (M, N) bf16 = act(bf16(a (M, K) @ w (K, N) + bias)); act 0 = none,
// 1 = erf-GELU followed by Philox dropout when drop_on (stream, thresh,
// inv_keep as in philox.cuh).  h_out (M, N) bf16, if not null, receives
// bf16(a @ w + bias) before the GELU.  Requires N % 128 == 0, K % 8 == 0
// and 16-byte aligned operands.
int nbk_gemm_bias_act(const void* a, const void* w, const float* bias,
                      void* out, void* h_out, int M, int N, int K, int act,
                      unsigned long long seed, int stream, unsigned thresh,
                      float inv_keep, int drop_on, void* cuda_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const DropParams d = make_drop(seed, stream, thresh, inv_keep, drop_on);
  Operands o = {};
  o.bias = bias;
  o.out_bf = static_cast<bf16*>(out);
  o.aux = static_cast<bf16*>(h_out);
  if (act == 0) return launch<false, EPI_BIAS>(a, w, o, d, M, N, K, s);
  if (act == 1) return launch<false, EPI_GELU>(a, w, o, d, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

// out (M, N) f32 = y2 + f32(resid (M, N) bf16), y2 = drop(f32(bf16(a @ w
// + bias))); y2d_out (M, N) bf16, if not null, receives bf16(y2).
// Requires N % 128 == 0, K % 8 == 0 and 16-byte aligned operands.
int nbk_gemm_bias_residual(const void* a, const void* w, const float* bias,
                           const void* resid, float* out, void* y2d_out,
                           int M, int N, int K, unsigned long long seed,
                           int stream, unsigned thresh, float inv_keep,
                           int drop_on, void* cuda_stream) {
  Operands o = {};
  o.bias = bias;
  o.resid = static_cast<const bf16*>(resid);
  o.out_f = out;
  o.aux = static_cast<bf16*>(y2d_out);
  return launch<false, EPI_RESIDUAL>(
      a, w, o, make_drop(seed, stream, thresh, inv_keep, drop_on), M, N, K,
      static_cast<cudaStream_t>(cuda_stream));
}

// out (M, N) f32 = y2 + f32(resid (M, N) bf16), y2 = drop(f32(bf16(((f32(
// a (M, K) s8 . wt (N, K) s8) * x_scale) * w_scale) + bias))); y2d_out (M,
// N) bf16, if not null, receives bf16(y2).  Requires N % 128 == 0, K % 16
// == 0 and 16-byte aligned operands.
int nbk_gemm_i8_bias_residual(const void* a, const float* x_scale,
                              const void* wt, const float* w_scale,
                              const float* bias, const void* resid,
                              float* out, void* y2d_out, int M, int N, int K,
                              unsigned long long seed, int stream,
                              unsigned thresh, float inv_keep, int drop_on,
                              void* cuda_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const DropParams d = make_drop(seed, stream, thresh, inv_keep, drop_on);
  Operands o = {};
  o.bias = bias;
  o.x_scale = x_scale;
  o.w_scale = w_scale;
  o.resid = static_cast<const bf16*>(resid);
  o.out_f = out;
  o.aux = static_cast<bf16*>(y2d_out);
  // serving's launches have neither dropout nor a saved y2
  return drop_on || y2d_out
             ? launch<true, EPI_RESIDUAL, true>(a, wt, o, d, M, N, K, s)
             : launch<true, EPI_RESIDUAL, false>(a, wt, o, d, M, N, K, s);
}

// The backwards' dgrads, a (M, K) @ w^T with w (N, K) row-major:
// epi 0 (dgelu): out = dh (M, N) bf16 = bf16(drop(a @ w^T) * gelu'(h)),
//   h (M, N) bf16; gd_out (M, N) bf16, if not null, receives
//   bf16(drop(gelu(h))).
// epi 1 (residual): out = dx (M, N) bf16 = bf16(ds + a @ w^T), ds (M, N)
//   f32.
// epi 2 (none): out (M, N) bf16 = bf16(a @ w^T).
int nbk_gemm_dgrad(const void* a, const void* w, void* out, const void* h,
                   void* gd_out, const float* ds, int M, int N, int K,
                   int epi, unsigned long long seed, int stream,
                   unsigned thresh, float inv_keep, int drop_on,
                   void* cuda_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const DropParams d = make_drop(seed, stream, thresh, inv_keep, drop_on);
  Operands o = {};
  o.h = static_cast<const bf16*>(h);
  o.ds = ds;
  o.out_bf = static_cast<bf16*>(out);
  o.aux = static_cast<bf16*>(gd_out);
  if (epi == 0) return launch<false, EPI_DGELU>(a, w, o, d, M, N, K, s);
  if (epi == 1) return launch<false, EPI_DX>(a, w, o, d, M, N, K, s);
  if (epi == 2) return launch<false, EPI_DNONE>(a, w, o, d, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

// out (M, N) bf16 = act(bf16(((f32(a (M, K) s8 . wt (N, K) s8) * x_scale)
// * w_scale) + bias)); act 0 = none, 1 = erf-GELU followed by Philox
// dropout when drop_on.  h_out (M, N) bf16, if not null, receives the bf16
// value before the GELU.  Requires N % 128 == 0, K % 16 == 0 and 16-byte
// aligned operands.
int nbk_gemm_i8_bias_act(const void* a, const float* x_scale, const void* wt,
                         const float* w_scale, const float* bias, void* out,
                         void* h_out, int M, int N, int K, int act,
                         unsigned long long seed, int stream, unsigned thresh,
                         float inv_keep, int drop_on, void* cuda_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const DropParams d = make_drop(seed, stream, thresh, inv_keep, drop_on);
  Operands o = {};
  o.bias = bias;
  o.x_scale = x_scale;
  o.w_scale = w_scale;
  o.out_bf = static_cast<bf16*>(out);
  o.aux = static_cast<bf16*>(h_out);
  if (act == 0) return launch<true, EPI_BIAS, false>(a, wt, o, d, M, N, K, s);
  if (act != 1) return (int)cudaErrorInvalidValue;
  // serving's GELU launch has neither dropout nor a saved h
  return drop_on || h_out
             ? launch<true, EPI_GELU, true>(a, wt, o, d, M, N, K, s)
             : launch<true, EPI_GELU, false>(a, wt, o, d, M, N, K, s);
}

// The int8 dgrads, d = f32(a (M, K) s8 . wt (N, K) s8 ^T) * g_scale (M,):
// epi 0 (dgelu): out = dh (M, N) bf16 = bf16(drop(d) * gelu'(h)), h (M, N)
//   bf16; dh_f32 (M, N) f32, if not null, receives dh unrounded; gd_out
//   (M, N) bf16, if not null, receives bf16(drop(gelu(h))).
// epi 1 (residual): out = dx (M, N) bf16 = bf16(ds + d), ds (M, N) f32.
// epi 2 (none): out (M, N) bf16 = bf16(d).
// Requires N % 128 == 0, K % 16 == 0 and 16-byte aligned operands.
int nbk_gemm_i8_dgrad(const void* a, const float* g_scale, const void* wt,
                      void* out, float* dh_f32, const void* h, void* gd_out,
                      const float* ds, int M, int N, int K, int epi,
                      unsigned long long seed, int stream, unsigned thresh,
                      float inv_keep, int drop_on, void* cuda_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const DropParams d = make_drop(seed, stream, thresh, inv_keep, drop_on);
  Operands o = {};
  o.x_scale = g_scale;
  o.h = static_cast<const bf16*>(h);
  o.ds = ds;
  o.out_bf = static_cast<bf16*>(out);
  o.out_f = dh_f32;
  o.aux = static_cast<bf16*>(gd_out);
  if (epi == 0) return launch<true, EPI_DGELU, true>(a, wt, o, d, M, N, K, s);
  if (epi == 1) return launch<true, EPI_DX, false>(a, wt, o, d, M, N, K, s);
  if (epi == 2) return launch<true, EPI_DNONE, false>(a, wt, o, d, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

const char* nbk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
