"""Int8 serving blocks: the port of ``nbest_asr_tpu/ops/int8_serving.py``
(``int8_ffn_block`` :105, ``int8_attention_block`` :201), whose Pallas
bodies are ``_ffn_i8_kernel`` (:90) and ``_attn_i8_kernel`` (:157).

Forward only and deterministic: per-output-channel symmetric int8
weights, per-token symmetric dynamic activation quant, exact int8 dots
with s32 accumulation, f32 dequant epilogues -- the numerics of
``quant.dense_int8``.  Mapping of each TPU megakernel onto the Hopper
kernel chain (``ops/kernels.py``, sources in ``csrc/``):

==============================================  ============================
``_ffn_i8_kernel``                               H100 kernel
==============================================  ============================
``_quant_rows(x)`` (:94 via ``_dense_i8``)      ``quantize_rows``
``_dot_i8`` + dequant + b1, GELU (:94-95)       ``gemm_i8_bias_act`` (gelu)
``_quant_rows(g)``, g the bf16 GELU (:96)       ``quantize_rows``
``_dot_i8`` + dequant + b2, ``+ x`` (:96-97)    ``gemm_i8_bias_residual``
LayerNorm (:98-102)                             ``layer_norm``
==============================================  ============================

==============================================  ============================
``_attn_i8_kernel``                              H100 kernel
==============================================  ============================
``_quant_rows(x)`` (:168 via ``_dense_i8``)     ``quantize_rows``
``_dot_i8`` + dequant + bqkv (:168)             ``gemm_i8_bias_act`` (none)
head loop, segment-masked softmax (:169-189)    ``seg_attention``
``_quant_rows(ctx)``, the bf16 ctx (:191)       ``quantize_rows``
``_dot_i8`` + dequant + bo, ``+ x`` (:191-193)  ``gemm_i8_bias_residual``
LayerNorm (:194-198)                            ``layer_norm``
==============================================  ============================

The TPU kernels keep the int8 weights resident in VMEM and the
quantized activations on chip; on the H100 the int8 activations, their
scales, the bf16 GELU / QKV / ctx buffers and the f32 residual sum pass
through HBM.  The second quant reads the ROUNDED bf16 GELU output or ctx,
as the TPU kernels do.  Weights ``wq`` keep the JAX shape (in, out) and
are stored column-major (``quant.kernel_layout``); scales are (1, out)
or (out,) f32.
"""

from __future__ import annotations

import torch

from .kernels import (MAX_SEQ, gemm_i8_bias_act, gemm_i8_bias_act_reference,
                      gemm_i8_bias_residual, gemm_i8_bias_residual_reference,
                      layer_norm_reference, layer_norm_rows, quantize_rows,
                      quantize_rows_reference, seg_attention,
                      seg_attention_reference)

I8_MAX_SEQ = MAX_SEQ


def int8_ffn_block(x: torch.Tensor, w1q, w1s, b1, w2q, w2s, b2, ln_scale,
                   ln_bias, *, eps: float = 1e-12) -> torch.Tensor:
    """LN(x + dense_i8(gelu(dense_i8(x)))).  x (..., h); w1q (h, i) int8;
    w2q (i, h) int8.  CUDA tensors run the kernel chain (bf16
    activations); CPU tensors run the plain version."""
    h = x.shape[-1]
    x2 = x.reshape(-1, h)
    g = gemm_i8_bias_act(*quantize_rows(x2), w1q, w1s.reshape(-1), b1,
                         act="gelu", out_dtype=x.dtype)
    s = gemm_i8_bias_residual(*quantize_rows(g), w2q, w2s.reshape(-1), b2,
                              x2)
    return layer_norm_rows(s, ln_scale, ln_bias, eps,
                           x.dtype).reshape(x.shape)


def int8_ffn_block_reference(x: torch.Tensor, w1q, w1s, b1, w2q, w2s, b2,
                             ln_scale, ln_bias, *,
                             eps: float = 1e-12) -> torch.Tensor:
    """The same block in plain PyTorch on any device."""
    h = x.shape[-1]
    x2 = x.reshape(-1, h)
    g = gemm_i8_bias_act_reference(*quantize_rows_reference(x2), w1q,
                                   w1s.reshape(-1), b1, act="gelu",
                                   out_dtype=x.dtype)
    s = gemm_i8_bias_residual_reference(*quantize_rows_reference(g), w2q,
                                        w2s.reshape(-1), b2, x2)
    return layer_norm_reference(s, ln_scale, ln_bias, eps,
                                x.dtype).reshape(x.shape)


def _check_seq(s: int) -> None:
    if s > I8_MAX_SEQ:
        raise ValueError(f"int8_attention_block: seq {s} > {I8_MAX_SEQ}")


def int8_attention_block(x: torch.Tensor, wqkvq, wqkvs, bqkv, woq, wos, bo,
                         ln_scale, ln_bias, attn_mask, *, n_heads: int,
                         eps: float = 1e-12) -> torch.Tensor:
    """LN(x + dense_i8(attn_seg(dense_i8(x)))).  x (b, s, h); wqkvq (h, 3h)
    int8 with q | k | v on the output axis; woq (h, h) int8; attn_mask
    (b, s) segment ids.  CUDA tensors run the kernel chain; CPU tensors
    run the plain version."""
    b, s, h = x.shape
    _check_seq(s)
    x2 = x.reshape(b * s, h)
    mask = attn_mask.to(torch.float32).contiguous()
    qkv = gemm_i8_bias_act(*quantize_rows(x2), wqkvq, wqkvs.reshape(-1),
                           bqkv, out_dtype=x.dtype)
    ctx = seg_attention(qkv, mask, n_heads)
    sres = gemm_i8_bias_residual(*quantize_rows(ctx), woq, wos.reshape(-1),
                                 bo, x2)
    y = layer_norm_rows(sres, ln_scale, ln_bias, eps, x.dtype)
    return y.reshape(b, s, h)


def int8_attention_block_reference(x: torch.Tensor, wqkvq, wqkvs, bqkv, woq,
                                   wos, bo, ln_scale, ln_bias, attn_mask, *,
                                   n_heads: int,
                                   eps: float = 1e-12) -> torch.Tensor:
    """The same block in plain PyTorch on any device."""
    b, s, h = x.shape
    _check_seq(s)
    x2 = x.reshape(b * s, h)
    mask = attn_mask.to(torch.float32)
    qkv = gemm_i8_bias_act_reference(*quantize_rows_reference(x2), wqkvq,
                                     wqkvs.reshape(-1), bqkv,
                                     out_dtype=x.dtype)
    ctx = seg_attention_reference(qkv, mask, n_heads)
    sres = gemm_i8_bias_residual_reference(*quantize_rows_reference(ctx),
                                           woq, wos.reshape(-1), bo, x2)
    y = layer_norm_reference(sres, ln_scale, ln_bias, eps, x.dtype)
    return y.reshape(b, s, h)
