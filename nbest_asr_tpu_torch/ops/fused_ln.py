"""Fused residual-add + LayerNorm -- the port of
``nbest_asr_tpu/ops/fused_ln.py:fused_residual_layer_norm`` (:154) and its
two Pallas bodies, ``_fwd_kernel`` (:33) and ``_bwd_kernel`` (:79), on the
hand-written ``residual_layer_norm`` and ``residual_layer_norm_bwd``
kernels (``csrc/layer_norm.cu``).

``LN(x + residual)`` over the last axis with the sum taken in f32 (not
rounded to the activation dtype first, as the plain ``layer_norm(x + r)``
rounds it), f32 statistics, output in x's dtype.  The backward returns
one dx for both x and the residual (:137), in each one's dtype, and
dscale / dbias in f32.  CUDA tensors run the kernels (bf16 or f32
activations, hidden sizes in ``kernels.ROW_WIDTHS``); CPU tensors their
plain versions.  The TPU's row padding to blocks of 256 is blocking, not
contract, and is not ported.
"""

from __future__ import annotations

import torch

from . import kernels as K


class _ResidualLN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, r, scale, bias, eps):
        y, mean, rstd = K.residual_layer_norm(x, r, scale, bias, eps)
        ctx.save_for_backward(x, r, scale, mean, rstd)
        ctx.dtypes = (r.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, r, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = K.residual_layer_norm_bwd(
            x, r, dy.contiguous(), scale, mean, rstd)
        r_dtype, bias_dtype = ctx.dtypes
        return (dx, dx.to(r_dtype), dscale.to(scale.dtype),
                dbias.to(bias_dtype), None)


def fused_residual_layer_norm(x: torch.Tensor, residual: torch.Tensor,
                              scale: torch.Tensor, bias: torch.Tensor,
                              eps: float = 1e-12) -> torch.Tensor:
    """LN(x + residual) over the last axis; any leading dims."""
    h = x.shape[-1]
    y = _ResidualLN.apply(x.reshape(-1, h).contiguous(),
                          residual.reshape(-1, h).contiguous(), scale, bias,
                          float(eps))
    return y.reshape(x.shape)
