"""FFN block: ``LN(x + drop2(drop1(gelu_erf(x @ w1 + b1)) @ w2 + b2))`` --
the port of ``nbest_asr_tpu/ops/fused_ffn.py:fused_ffn_block`` (:686),
whose Pallas bodies are ``_fwd_kernel`` (:166) and ``_bwd_kernel`` (:224)
around the ``_ffn_core`` custom VJP (:302-369), and of
``fused_ffn_block_int8_train`` (:645), whose bodies are ``_fwd_kernel_i8``
(:404) and ``_bwd_kernel_i8`` (:533) (see "Int8 training" below).

Mapping of the TPU megakernels onto the Hopper kernel chains
(``ops/kernels.py``, sources in ``csrc/``):

==============================================  ==============================
TPU                                             H100 kernel
==============================================  ==============================
``_fwd_kernel``
  ``_gelu_slice`` (:153): x @ w1 + b1, gelu,    ``gemm_bias_act`` (gelu,
  drop1                                         drop1; saves h)
  ``gd @ w2`` + b2, bf16, drop2, ``+ x``;       ``gemm_bias_residual`` (drop2;
  saves y2d (:181-191)                          saves y2d)
  LayerNorm; saves mean, rstd (:192-200)        ``layer_norm`` (stats)
``_bwd_kernel``
  ``_row_grads`` (:203-221): LN backward,       ``ffn_bwd_rows``
  drop2 -> (xhat, ds, dy2)
  ``dy2 @ w2^T``, drop1, ``* gelu'(h)``; gd     ``gemm_dgrad`` "dgelu"
  (:242-254)
  ``ds + dh @ w1^T`` (:239, :251, :258)         ``gemm_dgrad`` "residual"
``_ffn_core_bwd`` (:353-366): dW1, db1, dW2,    ``torch.matmul`` and ``sum``
db2, dls, dlb                                   (outside the kernels, as in
                                                JAX)
==============================================  ==============================

``gemm_bias_act``, ``gemm_bias_residual`` and ``gemm_dgrad`` are epilogues
of one persistent ``wgmma`` + TMA GEMM (``csrc/gemm_wgmma.cu``).

The TPU kernel keeps w1 and w2 (9.4 MB in bf16 at BERT-base) resident in
VMEM and never writes the (n, 3072) activations; on the H100 they pass
through HBM in bf16 between the kernels.  Rounding points are the TPU
kernels': the first GEMM's biased sum is rounded to bf16 (h) before the
f32 GELU and dropout, whose result is rounded again (gd); the second
GEMM's biased sum is rounded to bf16, dropped in f32 (multiplied by
f32(1/keep), not divided by keep as ``layers.dropout`` does) and saved as
y2d = bf16(y2), while the residual sum and the LN statistics use the
unrounded f32 y2.  The backward recomputes ``s`` from the bf16 y2d, as
the TPU kernel does.  The TPU kernel's erf is the A&S 7.1.26 polynomial
(max error 1.5e-7); the CUDA kernels use the exact ``erff``.

Saved residuals.  The TPU backward recomputes h with a GEMM.  Here the
forward saves h (n, 3072) bf16 instead -- 50 MB per layer at n = 8192,
one extra write against a 2 n h i-flop GEMM -- and the backward's "dgelu"
epilogue regenerates gd from h and the first mask (gd feeds dW2), so the
forward keeps (x, h, y2d, mean, rstd) and no mask.

Dropout masks are Philox keyed on (seed, stream, absolute row, column)
(``ops/philox.py``): stream 1 is the (n, intermediate) mask, stream 2 the
(n, hidden) one; the forward GEMM, the backward GEMM and the row pass
regenerate the same bits whatever their tiling.

Int8 training (``fused_ffn_block_int8_train``).  The weights are quantized
per output channel at every call from the compute-dtype weights the
encoder passes (``quant.quantize_train_weight``; XLA work outside the
Pallas body in JAX, plain torch here), and the forward runs both GEMMs in
int8 with the stage order, rounding points and masks of the bf16 chain:

==============================================  ==============================
TPU                                             H100 kernel
==============================================  ==============================
``_fwd_kernel_i8``
  ``_quant_rows_f32(x)`` (:417)                 ``quantize_rows``
  int8 x @ W1q, dequant + b1, bf16 h, GELU,     ``gemm_i8_bias_act`` (gelu,
  drop1 -> gd (:417-422)                        drop1; saves h)
  ``_quant_rows_f32(gd)``, int8 gd @ W2q,       ``quantize_rows``,
  dequant + b2, bf16, drop2, y2d, ``+ x``       ``gemm_i8_bias_residual``
  (:424-431)                                    (drop2; saves y2d)
  LayerNorm (:432-440)                          ``layer_norm`` (stats)
``_bwd_kernel_i8`` (``int8_bwd=True``)
  ``_row_grads``: LN backward, dy2 = drop2(ds)  ``ffn_bwd_rows``
  int8 recompute of h, gd (:550-559)            the forward's h; gd from the
                                                "dgelu" epilogue
  ``_dgrad_rows_i8(dy2, W2)``: fold, quant      ``quantize_grad_rows`` (drop2
  (:523-527)                                    redrawn from ds, * w2 scale)
  int8 dot, dequant, drop1, * gelu'(h) -> dh    ``gemm_i8_dgrad`` "dgelu" (dh
  (:528-530, :562-566)                          in bf16 and f32; gd)
  ``ds + _dgrad_rows_i8(dh, W1)`` (:548, :568)  ``quantize_grad_rows``,
                                                ``gemm_i8_dgrad`` "residual"
``_ffn_core_i8_bwd`` (:618-632): the wgrads     ``torch.matmul`` and ``sum``
==============================================  ==============================

With ``int8_bwd=False`` the backward is JAX's ``_ffn_core_i8`` (:486-502):
the bf16 ``_bwd_kernel`` fed the int8 forward's y2d, mean and rstd, which
recomputes h in the compute dtype from x (:241-243) -- so here the
backward runs ``gemm_bias_act`` (act none) for that h and then the bf16
chain (``ffn_bwd_rows``, ``gemm_dgrad`` "dgelu" and "residual"): the
gradients are straight-through w.r.t. the quantization except the
LayerNorm head.  With ``int8_bwd=True`` the forward keeps h (JAX's int8
recompute equals it bit for bit) and the int8 weights for the dgrads.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import (chain_ops, ffn_bwd_rows, gemm_bias_act,
                      gemm_bias_act_reference, gemm_bias_residual,
                      gemm_bias_residual_reference, gemm_dgrad,
                      layer_norm_reference, layer_norm_rows)
from .philox import STREAM_HIDDEN, STREAM_INTER, site
from .quant import quantize_train_weight


def _param_grads(x2, dy, dh, gd, dy2, xhat, ls, dtypes):
    """dW1, db1, dW2, db2, dls, dlb from the backward's tiles
    (``_ffn_core_bwd``, :353-366): the weight grads in the weights' dtype
    as an f32-accumulated product rounded once, as the JAX einsum with
    preferred f32."""
    b1_dt, b2_dt, lb_dt = dtypes
    f32 = torch.float32
    dw1 = torch.matmul(x2.t(), dh)
    dw2 = torch.matmul(gd.t(), dy2)
    db1 = dh.to(f32).sum(0).to(b1_dt)
    db2 = dy2.to(f32).sum(0).to(b2_dt)
    dy32 = dy.to(f32)
    dls = (dy32 * xhat.to(f32)).sum(0).to(ls.dtype)
    dlb = dy32.sum(0).to(lb_dt)
    return dw1, db1, dw2, db2, dls, dlb


class _FFNCore(torch.autograd.Function):
    """The training chain: five kernel launches a layer, forward and
    backward; the wgrads are plain reductions over the tiles the
    backward emits (``_ffn_core_bwd``)."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, ls, lb, seed, rate, eps):
        d1 = site(seed, rate, STREAM_INTER)
        d2 = site(seed, rate, STREAM_HIDDEN)
        h, gd = gemm_bias_act(x2, w1, b1, "gelu", drop=d1, save_h=True)
        s, y2d = gemm_bias_residual(gd, w2, b2, x2, drop=d2, save_y2d=True)
        y, mean, rstd = layer_norm_rows(s, ls, lb, eps, x2.dtype,
                                        stats=True)
        ctx.save_for_backward(x2, w1, w2, ls, h, y2d, mean, rstd)
        ctx.drops = (d1, d2)
        ctx.dtypes = (b1.dtype, b2.dtype, lb.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, w1, w2, ls, h, y2d, mean, rstd = ctx.saved_tensors
        d1, d2 = ctx.drops
        dy = dy.contiguous()
        dy2, xhat, ds = ffn_bwd_rows(x2, y2d, dy, ls, mean, rstd, drop=d2)
        dh, gd = gemm_dgrad(dy2, w2, "dgelu", h=h, drop=d1)
        dx = gemm_dgrad(dh, w1, "residual", ds=ds)
        return (dx, *_param_grads(x2, dy, dh, gd, dy2, xhat, ls, ctx.dtypes),
                None, None, None)


class _FFNCoreI8(torch.autograd.Function):
    """The int8 training chain (module docstring): five kernel launches a
    layer forward; backward six with ``int8_bwd`` (``_ffn_core_i8b``),
    else the bf16 chain after a bf16 recompute of h (``_ffn_core_i8``).
    ``plain`` runs every step on its plain version instead."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, ls, lb, seed, rate, eps, int8_bwd,
                plain):
        k = chain_ops(plain)
        d1 = site(seed, rate, STREAM_INTER)
        d2 = site(seed, rate, STREAM_HIDDEN)
        w1q, w1r, w1s = quantize_train_weight(w1)
        w2q, w2r, w2s = quantize_train_weight(w2)
        out = k.gemm_i8_bias_act(*k.quantize_rows(x2), w1q, w1s, b1, "gelu",
                                 x2.dtype, d1, int8_bwd)
        h, gd = out if int8_bwd else (None, out)
        s, y2d = k.gemm_i8_bias_residual(*k.quantize_rows(gd), w2q, w2s, b2,
                                         x2, d2, True)
        y, mean, rstd = k.layer_norm_rows(s, ls, lb, eps, x2.dtype, True)
        if int8_bwd:
            ctx.save_for_backward(x2, ls, y2d, mean, rstd, h, w1r, w1s, w2r,
                                  w2s)
        else:
            ctx.save_for_backward(x2, ls, y2d, mean, rstd, w1, b1, w2)
        ctx.int8_bwd, ctx.plain = int8_bwd, plain
        ctx.drops = (d1, d2)
        ctx.dtypes = (b1.dtype, b2.dtype, lb.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        k = chain_ops(ctx.plain)
        x2, ls, y2d, mean, rstd, *rest = ctx.saved_tensors
        d1, d2 = ctx.drops
        dy = dy.contiguous()
        dy2, xhat, ds = k.ffn_bwd_rows(x2, y2d, dy, ls, mean, rstd, d2)
        if ctx.int8_bwd:
            h, w1r, w1s, w2r, w2s = rest
            dh, dh32, gd = k.gemm_i8_dgrad(
                *k.quantize_grad_rows(ds, w2s, d2), w2r, "dgelu", h, None,
                d1, x2.dtype)
            dx = k.gemm_i8_dgrad(*k.quantize_grad_rows(dh32, w1s), w1r,
                                 "residual", None, ds, None, x2.dtype)
        else:
            w1, b1, w2 = rest
            h = k.gemm_bias_act(x2, w1, b1)
            dh, gd = k.gemm_dgrad(dy2, w2, "dgelu", h, None, d1)
            dx = k.gemm_dgrad(dh, w1, "residual", None, ds)
        return (dx, *_param_grads(x2, dy, dh, gd, dy2, xhat, ls, ctx.dtypes),
                None, None, None, None, None)


def _check_rate(rate: float, seed: Optional[int]) -> float:
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_ffn_block: dropout_rate {rate} not in "
                         "[0, 1)")
    if rate > 0.0 and seed is None:
        raise ValueError("fused_ffn_block: dropout_rate > 0 requires a "
                         "seed")
    return rate


def fused_ffn_block(x: torch.Tensor, w1, b1, w2, b2, ln_scale, ln_bias, *,
                    dropout_rate: float = 0.0, seed: Optional[int] = None,
                    eps: float = 1e-12) -> torch.Tensor:
    """x (..., h); w1 (h, inter); w2 (inter, h).  CUDA tensors run the
    kernel chains (bf16 activations and weights, f32 biases and LN
    params); CPU tensors run the plain versions.  ``seed`` keys the
    Philox dropout masks.  Where no gradient is needed and the rate is 0
    (serving) the forward saves nothing."""
    rate = _check_rate(dropout_rate, seed)
    h = x.shape[-1]
    x2 = x.reshape(-1, h)
    args = (x, w1, b1, w2, b2, ln_scale, ln_bias)
    if rate > 0.0 or (torch.is_grad_enabled()
                      and any(t.requires_grad for t in args)):
        y = _FFNCore.apply(x2.contiguous(), w1, b1, w2, b2, ln_scale,
                           ln_bias, seed, rate, float(eps))
        return y.reshape(x.shape)
    g = gemm_bias_act(x2, w1, b1, act="gelu")
    y = layer_norm_rows(gemm_bias_residual(g, w2, b2, x2), ln_scale,
                        ln_bias, eps, x.dtype)
    return y.reshape(x.shape)


def fused_ffn_block_reference(x: torch.Tensor, w1, b1, w2, b2, ln_scale,
                              ln_bias, *, dropout_rate: float = 0.0,
                              seed: Optional[int] = None,
                              eps: float = 1e-12) -> torch.Tensor:
    """The same block in plain PyTorch on any device, with the same
    Philox masks; differentiable by torch autograd."""
    rate = _check_rate(dropout_rate, seed)
    h = x.shape[-1]
    x2 = x.reshape(-1, h)
    gd = gemm_bias_act_reference(x2, w1, b1, "gelu",
                                 site(seed, rate, STREAM_INTER))
    s = gemm_bias_residual_reference(gd, w2, b2, x2,
                                     site(seed, rate, STREAM_HIDDEN))
    y = layer_norm_reference(s, ln_scale, ln_bias, eps, x.dtype)
    return y.reshape(x.shape)


def _int8_train(x, w1, b1, w2, b2, ln_scale, ln_bias, dropout_rate, seed,
                eps, int8_bwd, plain):
    rate = _check_rate(dropout_rate, seed)
    h, inter = x.shape[-1], w1.shape[1]
    # JAX streams f32 weights in 768-column slices, and its int8 forward
    # takes only the whole-weight layout (fused_ffn.py:68-76, :658-662)
    if x.dtype == torch.float32 and inter % 768 == 0 and inter != 768:
        raise ValueError(
            "int8-train FFN requires a non-streaming weight layout (bf16 "
            "compute); f32 streams inter slices whose dropout mask ids "
            "would diverge from the int8 forward's")
    y = _FFNCoreI8.apply(x.reshape(-1, h).contiguous(), w1, b1, w2, b2,
                         ln_scale, ln_bias, seed, rate, float(eps),
                         bool(int8_bwd), plain)
    return y.reshape(x.shape)


def fused_ffn_block_int8_train(x: torch.Tensor, w1, b1, w2, b2, ln_scale,
                               ln_bias, *, dropout_rate: float = 0.0,
                               seed: Optional[int] = None,
                               eps: float = 1e-12,
                               int8_bwd: bool = False) -> torch.Tensor:
    """``fused_ffn_block`` with int8 forward GEMMs and the bf16 backward,
    or with ``int8_bwd`` the int8-dgrad backward (module docstring).  w1,
    w2 are the compute-dtype weights (quantized here at every call); CUDA
    tensors run the kernel chains, CPU tensors their plain versions."""
    return _int8_train(x, w1, b1, w2, b2, ln_scale, ln_bias, dropout_rate,
                       seed, eps, int8_bwd, plain=False)


def fused_ffn_block_int8_train_reference(x: torch.Tensor, w1, b1, w2, b2,
                                         ln_scale, ln_bias, *,
                                         dropout_rate: float = 0.0,
                                         seed: Optional[int] = None,
                                         eps: float = 1e-12,
                                         int8_bwd: bool = False
                                         ) -> torch.Tensor:
    """The same block, forward and backward, on the plain versions of its
    kernels on any device, with the same Philox masks."""
    return _int8_train(x, w1, b1, w2, b2, ln_scale, ln_bias, dropout_rate,
                       seed, eps, int8_bwd, plain=True)
