"""Attention block forward: ``LN(x + out_proj(attn(QKV(x))))`` -- the
port of ``nbest_asr_tpu/ops/fused_attention.py:fused_attention_block``
(:759) at dropout rate 0, whose Pallas body is ``_fab_fwd_kernel`` (:152).

Mapping of the TPU megakernel onto the Hopper kernel chain
(``ops/kernels.py``, sources in ``csrc/``):

==========================================  ===========================
``_fab_fwd_kernel``                          H100 kernel
==========================================  ===========================
``_qkv_gemm`` (:143): x @ wqkv + bqkv        ``gemm_bias_act`` (none)
head loop + ``_head_probs`` (:167-180)      ``seg_attention``
``ctx @ wo + bo``, bf16, ``+ x`` (:182-188)  ``gemm_bias_residual``
LayerNorm (:189-194)                        ``layer_norm``
==========================================  ===========================

The TPU kernel keeps wqkv and wo resident in VMEM and a whole batch
block's QKV on chip; an SM has 227 KB of shared memory, so the chain
passes QKV (n, 3h) bf16, ctx (n, h) bf16 and the residual sum (n, h) f32
through HBM.  Rounding points are the TPU kernel's: QKV, probs, ctx and
the out-proj result are rounded to bf16, the residual sum and LN run in
f32.  The saved residuals (``od``, mean, rstd) and the dropout streams
arrive with the backward kernels in the training slice.
"""

from __future__ import annotations

import torch

from .kernels import (MAX_SEQ, gemm_bias_act, gemm_bias_act_reference,
                      gemm_bias_residual, gemm_bias_residual_reference,
                      layer_norm_reference, layer_norm_rows, seg_attention,
                      seg_attention_reference)

FAB_MAX_SEQ = MAX_SEQ


def _no_dropout(attn_dropout: float, hidden_dropout: float) -> None:
    if attn_dropout > 0.0 or hidden_dropout > 0.0:
        raise NotImplementedError(
            "fused_attention_block: dropout rate > 0 needs the Philox "
            "dropout streams that land with the backward kernels "
            "(ROADMAP queue 1, training step); this forward runs at rate 0")


def fused_attention_block(x: torch.Tensor, wqkv, bqkv, wo, bo, ln_scale,
                          ln_bias, attn_mask, *, n_heads: int,
                          attn_dropout: float = 0.0,
                          hidden_dropout: float = 0.0,
                          eps: float = 1e-12) -> torch.Tensor:
    """x (b, s, h); wqkv (h, 3h) with q | k | v on the output axis; wo
    (h, h); attn_mask (b, s) segment ids.  CUDA tensors run the kernel
    chain (bf16 activations and weights, f32 biases and LN params); CPU
    tensors run the plain version."""
    _no_dropout(attn_dropout, hidden_dropout)
    b, s, h = x.shape
    if s > FAB_MAX_SEQ:
        raise ValueError(f"fused_attention_block: seq {s} > {FAB_MAX_SEQ}")
    x2 = x.reshape(b * s, h)
    mask = attn_mask.to(torch.float32).contiguous()
    qkv = gemm_bias_act(x2, wqkv, bqkv)
    ctx = seg_attention(qkv, mask, n_heads)
    y = layer_norm_rows(gemm_bias_residual(ctx, wo, bo, x2), ln_scale,
                        ln_bias, eps, x.dtype)
    return y.reshape(b, s, h)


def fused_attention_block_reference(x: torch.Tensor, wqkv, bqkv, wo, bo,
                                    ln_scale, ln_bias, attn_mask, *,
                                    n_heads: int, attn_dropout: float = 0.0,
                                    hidden_dropout: float = 0.0,
                                    eps: float = 1e-12) -> torch.Tensor:
    """The same block in plain PyTorch on any device."""
    _no_dropout(attn_dropout, hidden_dropout)
    b, s, h = x.shape
    x2 = x.reshape(b * s, h)
    mask = attn_mask.to(torch.float32)
    qkv = gemm_bias_act_reference(x2, wqkv, bqkv)
    ctx = seg_attention_reference(qkv, mask, n_heads)
    y = layer_norm_reference(
        gemm_bias_residual_reference(ctx, wo, bo, x2), ln_scale, ln_bias,
        eps, x.dtype)
    return y.reshape(b, s, h)
