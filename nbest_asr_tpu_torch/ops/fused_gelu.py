"""Fused bias-add + GELU -- the port of
``nbest_asr_tpu/ops/fused_gelu.py:fused_bias_gelu`` (:92) and its two
Pallas bodies, ``_fwd_kernel`` (:41) and ``_bwd_kernel`` (:47), on the
hand-written ``bias_gelu`` and ``bias_gelu_bwd`` kernels
(``csrc/fused_gelu.cu``).

``gelu(x + bias)`` over the last axis in f32 with erf from Abramowitz &
Stegun 7.1.26 (the TPU kernel's function, within 1.5e-7 of the exact
erf), output in x's dtype.  dbias is the column sum of f32(dx), taken
outside the kernel as JAX takes it (:85), and has the bias's own shape:
JAX returns shape (h,) for its (1, h) primal, which its custom VJP
rejects (ROADMAP.md, queue 3 item 1), so the port's gradient is held to
autograd through the plain version instead.  CUDA tensors run the
kernels; CPU tensors their plain versions.
"""

from __future__ import annotations

import torch

from . import kernels as K


class _BiasGelu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, bias):
        b = bias.reshape(-1)
        ctx.save_for_backward(x, b)
        ctx.bias_shape = bias.shape
        return K.bias_gelu(x, b)

    @staticmethod
    def backward(ctx, dy):
        x, b = ctx.saved_tensors
        dx = K.bias_gelu_bwd(x, b, dy.contiguous())
        db = dx.to(torch.float32).sum(dim=0).to(b.dtype)
        return dx, db.reshape(ctx.bias_shape)


def fused_bias_gelu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """gelu(x + bias) over the last axis; any leading dims; bias (h,) or
    (1, h) f32."""
    h = x.shape[-1]
    return _BiasGelu.apply(x.reshape(-1, h).contiguous(),
                           bias).reshape(x.shape)
