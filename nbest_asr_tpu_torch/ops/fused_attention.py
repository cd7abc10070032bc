"""Attention block: ``LN(x + drop_h(out_proj(attn(QKV(x)))))``, with
Philox prob and hidden dropout -- the port of
``nbest_asr_tpu/ops/fused_attention.py:fused_attention_block`` (:759),
whose Pallas bodies are ``_fab_fwd_kernel`` (:152) and ``_fab_bwd_kernel``
(:204) around the ``_fab_core`` custom VJP (:365-407), and of
``fused_attention_block_int8_train`` (:711), whose bodies are
``_fab_fwd_kernel_i8`` (:436) and ``_fab_bwd_kernel_i8`` (:565) (see "Int8
training" below).

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

``gemm_bias_act``, ``gemm_bias_residual`` and ``gemm_dgrad`` are epilogues
of one persistent ``wgmma`` + TMA GEMM (``csrc/gemm_wgmma.cu``).

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

Int8 training (``fused_attention_block_int8_train``).  The QKV and out-proj
weights are quantized per output channel at every call from the
compute-dtype weights (``quant.quantize_train_weight``); the attention
math, both dropouts and the LayerNorm stay the bf16 chain's:

==============================================  ==============================
TPU                                             H100 kernel
==============================================  ==============================
``_fab_fwd_kernel_i8``
  ``_dense_rows_i8(x)``: quant, int8 QKV,       ``quantize_rows``,
  dequant + bqkv, bf16 (:454-455)               ``gemm_i8_bias_act`` (none)
  head loop, prob drop (:456-469)               ``seg_attention`` (stream 3,
                                                row statistics)
  ``_dense_rows_i8(ctx)``, bf16, hidden drop,   ``quantize_rows``,
  od, ``+ x`` (:471-478)                        ``gemm_i8_bias_residual``
                                                (stream 4; saves od)
  LayerNorm (:479-486)                          ``layer_norm`` (stats)
``_fab_bwd_kernel_i8`` (``int8_bwd=True``)
  LN backward, dout = drop_h(ds) (:583-596)     ``ffn_bwd_rows``
  dctx = ``_dgrad_rows_i8(dout, Wo)``, bf16     ``quantize_grad_rows`` (drop
  per head (:597, :609)                         redrawn from ds, * wo scale),
                                                ``gemm_i8_dgrad`` "none"
  int8 QKV recompute, head loop (:599-631)      the forward's qkv, ctx and row
                                                statistics; ``seg_attention_bwd``
  ``ds + _dgrad_rows_i8(dqkv, Wqkv)``           ``quantize_grad_rows``,
  (:633-635)                                    ``gemm_i8_dgrad`` "residual"
``_fab_core_i8_bwd`` (:679-695): the wgrads     ``torch.matmul`` and ``sum``
==============================================  ==============================

With ``int8_bwd=False`` the backward is JAX's ``_fab_core_i8`` (:528-550):
the bf16 ``_fab_bwd_kernel`` fed the int8 forward's od, mean and rstd,
which recomputes qkv in the compute dtype (:234), the probs from it and
ctx for dWo (:254, :266) -- so here the backward runs ``gemm_bias_act``
for that qkv and ``seg_attention`` on it with the same stream-3 mask (for
its row statistics and ctx), then the bf16 chain.  With ``int8_bwd=True``
the int8 recompute equals the forward bit for bit, so the forward keeps
its qkv, ctx and statistics.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import (MAX_SEQ, chain_ops, ffn_bwd_rows, gemm_bias_act,
                      gemm_bias_act_reference, gemm_bias_residual,
                      gemm_bias_residual_reference, gemm_dgrad,
                      layer_norm_reference, layer_norm_rows, seg_attention,
                      seg_attention_bwd, seg_attention_reference)
from .philox import STREAM_ATTN_HIDDEN, STREAM_ATTN_PROB, site
from .quant import quantize_train_weight

FAB_MAX_SEQ = MAX_SEQ


def _param_grads(x2, dy, dqkv, c, dout, xhat, ls, dtypes):
    """dWqkv, dbqkv, dWo, dbo, dls, dlb from the backward's tiles
    (``_fab_core_bwd``, :382-404): the weight grads in the weights' dtype
    as an f32-accumulated product rounded once, as the JAX einsum with
    preferred f32."""
    bqkv_dt, bo_dt, lb_dt = dtypes
    f32 = torch.float32
    dwqkv = torch.matmul(x2.t(), dqkv)
    dwo = torch.matmul(c.t(), dout)
    dbqkv = dqkv.to(f32).sum(0).to(bqkv_dt)
    dbo = dout.to(f32).sum(0).to(bo_dt)
    dy32 = dy.to(f32)
    dls = (dy32 * xhat.to(f32)).sum(0).to(ls.dtype)
    dlb = dy32.sum(0).to(lb_dt)
    return dwqkv, dbqkv, dwo, dbo, dls, dlb


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
        dy = dy.contiguous()
        dout, xhat, ds = ffn_bwd_rows(x2, od, dy, ls, mean, rstd, drop=dh)
        dctx = gemm_dgrad(dout, wo, "none")
        dqkv = seg_attention_bwd(qkv, dctx, mask, st, ctx.n_heads, drop=da)
        dx = gemm_dgrad(dqkv, wqkv, "residual", ds=ds)
        return (dx, *_param_grads(x2, dy, dqkv, c, dout, xhat, ls,
                                  ctx.dtypes),
                None, None, None, None, None, None)


class _AttnCoreI8(torch.autograd.Function):
    """The int8 training chain (module docstring): six kernel launches a
    layer forward; backward six with ``int8_bwd`` (``_fab_core_i8b``),
    else the bf16 chain after a bf16 recompute of qkv and of the
    attention (``_fab_core_i8``).  ``plain`` runs every step on its plain
    version instead."""

    @staticmethod
    def forward(ctx, x2, wqkv, bqkv, wo, bo, ls, lb, mask, n_heads, seed,
                a_rate, h_rate, eps, int8_bwd, plain):
        k = chain_ops(plain)
        da = site(seed, a_rate, STREAM_ATTN_PROB)
        dh = site(seed, h_rate, STREAM_ATTN_HIDDEN)
        wqkvq, wqkvr, wqkvs = quantize_train_weight(wqkv)
        woq, wor, wos = quantize_train_weight(wo)
        qkv = k.gemm_i8_bias_act(*k.quantize_rows(x2), wqkvq, wqkvs, bqkv,
                                 "none", x2.dtype)
        c, st = k.seg_attention(qkv, mask, n_heads, da, True)
        s, od = k.gemm_i8_bias_residual(*k.quantize_rows(c), woq, wos, bo, x2,
                                        dh, True)
        y, mean, rstd = k.layer_norm_rows(s, ls, lb, eps, x2.dtype, True)
        if int8_bwd:
            ctx.save_for_backward(x2, ls, mask, od, mean, rstd, qkv, c, st,
                                  wqkvr, wqkvs, wor, wos)
        else:
            ctx.save_for_backward(x2, ls, mask, od, mean, rstd, wqkv, bqkv,
                                  wo)
        ctx.int8_bwd, ctx.plain, ctx.n_heads = int8_bwd, plain, n_heads
        ctx.drops = (da, dh)
        ctx.dtypes = (bqkv.dtype, bo.dtype, lb.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        k = chain_ops(ctx.plain)
        x2, ls, mask, od, mean, rstd, *rest = ctx.saved_tensors
        da, dh = ctx.drops
        nh = ctx.n_heads
        dy = dy.contiguous()
        dout, xhat, ds = k.ffn_bwd_rows(x2, od, dy, ls, mean, rstd, dh)
        if ctx.int8_bwd:
            qkv, c, st, wqkvr, wqkvs, wor, wos = rest
            dctx = k.gemm_i8_dgrad(*k.quantize_grad_rows(ds, wos, dh), wor,
                                   "none", None, None, None, x2.dtype)
            dqkv = k.seg_attention_bwd(qkv, dctx, mask, st, nh, da)
            dx = k.gemm_i8_dgrad(*k.quantize_grad_rows(dqkv, wqkvs), wqkvr,
                                 "residual", None, ds, None, x2.dtype)
        else:
            wqkv, bqkv, wo = rest
            dctx = k.gemm_dgrad(dout, wo, "none")
            qkv = k.gemm_bias_act(x2, wqkv, bqkv)
            c, st = k.seg_attention(qkv, mask, nh, da, True)
            dqkv = k.seg_attention_bwd(qkv, dctx, mask, st, nh, da)
            dx = k.gemm_dgrad(dqkv, wqkv, "residual", None, ds)
        return (dx, *_param_grads(x2, dy, dqkv, c, dout, xhat, ls,
                                  ctx.dtypes),
                None, None, None, None, None, None, None, None)


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


def _int8_train(x, wqkv, bqkv, wo, bo, ln_scale, ln_bias, attn_mask, n_heads,
                attn_dropout, hidden_dropout, seed, eps, int8_bwd, plain):
    b, s, h = x.shape
    a_rate, h_rate = _check(s, attn_dropout, hidden_dropout, seed)
    y = _AttnCoreI8.apply(x.reshape(b * s, h).contiguous(), wqkv, bqkv, wo,
                          bo, ln_scale, ln_bias,
                          attn_mask.to(torch.float32).contiguous(),
                          int(n_heads), seed, a_rate, h_rate, float(eps),
                          bool(int8_bwd), plain)
    return y.reshape(b, s, h)


def fused_attention_block_int8_train(x: torch.Tensor, wqkv, bqkv, wo, bo,
                                     ln_scale, ln_bias, attn_mask, *,
                                     n_heads: int, attn_dropout: float = 0.0,
                                     hidden_dropout: float = 0.0,
                                     seed: Optional[int] = None,
                                     eps: float = 1e-12,
                                     int8_bwd: bool = False) -> torch.Tensor:
    """``fused_attention_block`` with int8 QKV and out-proj GEMMs and the
    bf16 backward, or with ``int8_bwd`` the int8-dgrad backward (module
    docstring).  wqkv, wo are the compute-dtype weights (quantized here at
    every call); CUDA tensors run the kernel chains, CPU tensors their
    plain versions."""
    return _int8_train(x, wqkv, bqkv, wo, bo, ln_scale, ln_bias, attn_mask,
                       n_heads, attn_dropout, hidden_dropout, seed, eps,
                       int8_bwd, plain=False)


def fused_attention_block_int8_train_reference(
        x: torch.Tensor, wqkv, bqkv, wo, bo, ln_scale, ln_bias, attn_mask,
        *, n_heads: int, attn_dropout: float = 0.0,
        hidden_dropout: float = 0.0, seed: Optional[int] = None,
        eps: float = 1e-12, int8_bwd: bool = False) -> torch.Tensor:
    """The same block, forward and backward, on the plain versions of its
    kernels on any device, with the same Philox masks."""
    return _int8_train(x, wqkv, bqkv, wo, bo, ln_scale, ln_bias, attn_mask,
                       n_heads, attn_dropout, hidden_dropout, seed, eps,
                       int8_bwd, plain=True)
