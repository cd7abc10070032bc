"""FFN block: ``LN(x + drop2(drop1(gelu_erf(x @ w1 + b1)) @ w2 + b2))`` --
the port of ``nbest_asr_tpu/ops/fused_ffn.py:fused_ffn_block`` (:686),
whose Pallas bodies are ``_fwd_kernel`` (:166) and ``_bwd_kernel`` (:224)
around the ``_ffn_core`` custom VJP (:302-369).

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
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import (ffn_bwd_rows, gemm_bias_act, gemm_bias_act_reference,
                      gemm_bias_residual, gemm_bias_residual_reference,
                      gemm_dgrad, layer_norm_reference, layer_norm_rows)
from .philox import STREAM_HIDDEN, STREAM_INTER, site


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
        b1_dt, b2_dt, lb_dt = ctx.dtypes
        dy = dy.contiguous()
        dy2, xhat, ds = ffn_bwd_rows(x2, y2d, dy, ls, mean, rstd, drop=d2)
        dh, gd = gemm_dgrad(dy2, w2, "dgelu", h=h, drop=d1)
        dx = gemm_dgrad(dh, w1, "residual", ds=ds)
        # dw1 / dw2 in the weights' dtype: an f32-accumulated product
        # rounded once, as the JAX einsum with preferred f32
        dw1 = torch.matmul(x2.t(), dh)
        dw2 = torch.matmul(gd.t(), dy2)
        f32 = torch.float32
        db1 = dh.to(f32).sum(0).to(b1_dt)
        db2 = dy2.to(f32).sum(0).to(b2_dt)
        dy32 = dy.to(f32)
        dls = (dy32 * xhat.to(f32)).sum(0).to(ls.dtype)
        dlb = dy32.sum(0).to(lb_dt)
        return dx, dw1, db1, dw2, db2, dls, dlb, None, None, None


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
