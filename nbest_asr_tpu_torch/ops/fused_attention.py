"""Attention block: ``LN(x + drop_h(out_proj(attn(QKV(x)))))``, with
Philox prob and hidden dropout -- the port of
``nbest_asr_tpu/ops/fused_attention.py:fused_attention_block`` (:759),
whose Pallas bodies are ``_fab_fwd_kernel`` (:152) and ``_fab_bwd_kernel``
(:204) around the ``_fab_core`` custom VJP (:365-407).

Mapping of the TPU megakernels onto the Hopper kernel chains
(``ops/kernels.py``, sources in ``csrc/``):

==============================================  ==============================
TPU                                             H100 kernel
==============================================  ==============================
``_fab_fwd_kernel``
  ``_qkv_gemm`` (:143): x @ wqkv + bqkv         ``gemm_bias_act`` (none; qkv
                                                kept for the backward)
  head loop, ``_head_probs`` (:167-180): seg-   ``seg_attention`` (prob drop,
  masked softmax, prob drop, bf16 P.V           stream 3; saves row max/sum)
  ``ctx @ wo + bo``, bf16, hidden drop, ``+     ``gemm_bias_residual`` (drop,
  x``; saves od (:182-188)                      stream 4; saves od)
  LayerNorm; saves mean, rstd (:189-196)        ``layer_norm`` (stats)
``_fab_bwd_kernel``
  LN backward, hidden drop -> (xhat, ds,        ``ffn_bwd_rows`` (the FFN
  dout) (:216-231)                              block's row pass)
  dctx = dout @ wo^T, bf16 (:232, :243)         ``gemm_dgrad`` "none"
  QKV recompute, per-head dp, dv, di, ds,       ``seg_attention_bwd`` (dq
  dq, dk (:234-265)                             kernel, then dk/dv kernel)
  ``ds + dqkv @ wqkv^T`` (:268-269)             ``gemm_dgrad`` "residual"
``_fab_core_bwd`` (:382-404): dWqkv, dbqkv,     ``torch.matmul`` and ``sum``
dWo, dbo, dls, dlb                              (outside the kernels, as in
                                                JAX)
==============================================  ==============================

The TPU kernel keeps wqkv and wo resident in VMEM and a whole batch
block's QKV on chip; an SM has 227 KB of shared memory, so the chain
passes QKV (n, 3h) bf16, ctx (n, h) bf16 and the residual sum (n, h) f32
through HBM.  Rounding points are the TPU kernel's: QKV, probs, ctx and
the out-proj result are rounded to bf16; the prob dropout multiplies the
normalised f32 probs by f32(1/keep) before their rounding; the hidden
dropout drops the rounded out-proj result in f32, the residual sum uses
that unrounded f32 value and od is its bf16 rounding; the residual sum
and LN run in f32.

Saved residuals.  The TPU backward recomputes QKV with a GEMM and ctx
per head.  Here the forward keeps qkv (it passes through HBM anyway) and
ctx (for dWo), plus od, the LN mean and rstd and the softmax row max and
sum (8 bytes a row per head, so the backward rebuilds p without a pass
over the keys); no (s, s) probs and no mask are stored.

Dropout masks are Philox keyed on (seed, stream, row, column)
(``ops/philox.py``): stream 3 is the prob mask at row ``(elem * n_heads
+ head) * s + q``, column ``k``; stream 4 the (n, hidden) out-proj mask.
One seed serves the block, as JAX's one ``dropout_rng`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import (MAX_SEQ, ffn_bwd_rows, gemm_bias_act,
                      gemm_bias_act_reference, gemm_bias_residual,
                      gemm_bias_residual_reference, gemm_dgrad,
                      layer_norm_reference, layer_norm_rows, seg_attention,
                      seg_attention_bwd, seg_attention_reference)
from .philox import STREAM_ATTN_HIDDEN, STREAM_ATTN_PROB, site

FAB_MAX_SEQ = MAX_SEQ


class _AttnCore(torch.autograd.Function):
    """The training chain: four kernel launches a layer forward, four
    backward (``seg_attention_bwd`` is two kernels); the wgrads are plain
    reductions over the tiles the backward emits (``_fab_core_bwd``)."""

    @staticmethod
    def forward(ctx, x2, wqkv, bqkv, wo, bo, ls, lb, mask, n_heads, seed,
                a_rate, h_rate, eps):
        da = site(seed, a_rate, STREAM_ATTN_PROB)
        dh = site(seed, h_rate, STREAM_ATTN_HIDDEN)
        qkv = gemm_bias_act(x2, wqkv, bqkv)
        c, st = seg_attention(qkv, mask, n_heads, drop=da, stats=True)
        s, od = gemm_bias_residual(c, wo, bo, x2, drop=dh, save_y2d=True)
        y, mean, rstd = layer_norm_rows(s, ls, lb, eps, x2.dtype,
                                        stats=True)
        ctx.save_for_backward(x2, wqkv, wo, ls, mask, qkv, c, st, od, mean,
                              rstd)
        ctx.drops = (da, dh)
        ctx.n_heads = n_heads
        ctx.dtypes = (bqkv.dtype, bo.dtype, lb.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, wqkv, wo, ls, mask, qkv, c, st, od, mean, rstd = \
            ctx.saved_tensors
        da, dh = ctx.drops
        bqkv_dt, bo_dt, lb_dt = ctx.dtypes
        dy = dy.contiguous()
        dout, xhat, ds = ffn_bwd_rows(x2, od, dy, ls, mean, rstd, drop=dh)
        dctx = gemm_dgrad(dout, wo, "none")
        dqkv = seg_attention_bwd(qkv, dctx, mask, st, ctx.n_heads, drop=da)
        dx = gemm_dgrad(dqkv, wqkv, "residual", ds=ds)
        # weight grads in the weights' dtype: an f32-accumulated product
        # rounded once, as the JAX einsum with preferred f32
        dwqkv = torch.matmul(x2.t(), dqkv)
        dwo = torch.matmul(c.t(), dout)
        f32 = torch.float32
        dbqkv = dqkv.to(f32).sum(0).to(bqkv_dt)
        dbo = dout.to(f32).sum(0).to(bo_dt)
        dy32 = dy.to(f32)
        dls = (dy32 * xhat.to(f32)).sum(0).to(ls.dtype)
        dlb = dy32.sum(0).to(lb_dt)
        return (dx, dwqkv, dbqkv, dwo, dbo, dls, dlb, None, None, None, None,
                None, None)


def _check(s: int, attn_dropout: float, hidden_dropout: float,
           seed: Optional[int]):
    if s > FAB_MAX_SEQ:
        raise ValueError(f"fused_attention_block: seq {s} > {FAB_MAX_SEQ}")
    rates = float(attn_dropout), float(hidden_dropout)
    for r in rates:
        if not 0.0 <= r < 1.0:
            raise ValueError(f"fused_attention_block: dropout rate {r} not "
                             "in [0, 1)")
    if max(rates) > 0.0 and seed is None:
        raise ValueError("fused_attention_block: dropout rate > 0 requires "
                         "a seed")
    return rates


def fused_attention_block(x: torch.Tensor, wqkv, bqkv, wo, bo, ln_scale,
                          ln_bias, attn_mask, *, n_heads: int,
                          attn_dropout: float = 0.0,
                          hidden_dropout: float = 0.0,
                          seed: Optional[int] = None,
                          eps: float = 1e-12) -> torch.Tensor:
    """x (b, s, h); wqkv (h, 3h) with q | k | v on the output axis; wo
    (h, h); attn_mask (b, s) segment ids.  CUDA tensors run the kernel
    chains (bf16 activations and weights, f32 biases and LN params); CPU
    tensors run the plain versions.  ``seed`` keys the Philox dropout
    masks.  Where no gradient is needed and both rates are 0 (serving)
    the forward saves nothing."""
    b, s, h = x.shape
    a_rate, h_rate = _check(s, attn_dropout, hidden_dropout, seed)
    x2 = x.reshape(b * s, h)
    mask = attn_mask.to(torch.float32).contiguous()
    args = (x, wqkv, bqkv, wo, bo, ln_scale, ln_bias)
    if a_rate > 0.0 or h_rate > 0.0 or (
            torch.is_grad_enabled() and any(t.requires_grad for t in args)):
        y = _AttnCore.apply(x2.contiguous(), wqkv, bqkv, wo, bo, ln_scale,
                            ln_bias, mask, int(n_heads), seed, a_rate,
                            h_rate, float(eps))
        return y.reshape(b, s, h)
    qkv = gemm_bias_act(x2, wqkv, bqkv)
    ctx = seg_attention(qkv, mask, n_heads)
    y = layer_norm_rows(gemm_bias_residual(ctx, wo, bo, x2), ln_scale,
                        ln_bias, eps, x.dtype)
    return y.reshape(b, s, h)


def fused_attention_block_reference(x: torch.Tensor, wqkv, bqkv, wo, bo,
                                    ln_scale, ln_bias, attn_mask, *,
                                    n_heads: int, attn_dropout: float = 0.0,
                                    hidden_dropout: float = 0.0,
                                    seed: Optional[int] = None,
                                    eps: float = 1e-12) -> torch.Tensor:
    """The same block in plain PyTorch on any device, with the same
    Philox masks; differentiable by torch autograd."""
    b, s, h = x.shape
    a_rate, h_rate = _check(s, attn_dropout, hidden_dropout, seed)
    x2 = x.reshape(b * s, h)
    mask = attn_mask.to(torch.float32)
    qkv = gemm_bias_act_reference(x2, wqkv, bqkv)
    ctx = seg_attention_reference(qkv, mask, n_heads,
                                  site(seed, a_rate, STREAM_ATTN_PROB))
    y = layer_norm_reference(
        gemm_bias_residual_reference(ctx, wo, bo, x2,
                                     site(seed, h_rate, STREAM_ATTN_HIDDEN)),
        ln_scale, ln_bias, eps, x.dtype)
    return y.reshape(b, s, h)
