"""FFN block forward: ``LN(x + gelu_erf(x @ w1 + b1) @ w2 + b2)`` -- the
port of ``nbest_asr_tpu/ops/fused_ffn.py:fused_ffn_block`` (:686) at
dropout rate 0, whose Pallas body is ``_fwd_kernel`` (:166).

Mapping of the TPU megakernel onto the Hopper kernel chain
(``ops/kernels.py``, sources in ``csrc/``):

==========================================  ===========================
``_fwd_kernel``                              H100 kernel
==========================================  ===========================
``_gelu_slice`` (:153): x @ w1 + b1, gelu   ``gemm_bias_act`` (gelu)
``gd @ w2`` + b2, bf16, ``+ x`` (:181-191)  ``gemm_bias_residual``
LayerNorm (:192-198)                        ``layer_norm``
==========================================  ===========================

The TPU kernel keeps w1 and w2 (9.4 MB in bf16 at BERT-base) resident in
VMEM and never writes the (n, 3072) GELU activations; on the H100 they
pass through HBM in bf16 between the two GEMMs.  Rounding points are the
TPU kernel's: the first GEMM's biased sum is rounded to bf16 before the
f32 GELU, whose result is rounded again; the second GEMM's biased sum is
rounded to bf16, the residual sum and LN run in f32.  The TPU kernel's
erf is the A&S 7.1.26 polynomial (max error 1.5e-7); the CUDA kernel uses
the exact ``erff``.
"""

from __future__ import annotations

import torch

from .kernels import (gemm_bias_act, gemm_bias_act_reference,
                      gemm_bias_residual, gemm_bias_residual_reference,
                      layer_norm_reference, layer_norm_rows)


def _no_dropout(rate: float) -> None:
    if rate > 0.0:
        raise NotImplementedError(
            "fused_ffn_block: dropout rate > 0 needs the Philox dropout "
            "streams that land with the backward kernels (ROADMAP queue 1, "
            "training step); this forward runs at rate 0")


def fused_ffn_block(x: torch.Tensor, w1, b1, w2, b2, ln_scale, ln_bias, *,
                    dropout_rate: float = 0.0,
                    eps: float = 1e-12) -> torch.Tensor:
    """x (..., h); w1 (h, inter); w2 (inter, h).  CUDA tensors run the
    kernel chain (bf16 activations and weights, f32 biases and LN
    params); CPU tensors run the plain version."""
    _no_dropout(dropout_rate)
    h = x.shape[-1]
    x2 = x.reshape(-1, h)
    g = gemm_bias_act(x2, w1, b1, act="gelu")
    y = layer_norm_rows(gemm_bias_residual(g, w2, b2, x2), ln_scale,
                        ln_bias, eps, x.dtype)
    return y.reshape(x.shape)


def fused_ffn_block_reference(x: torch.Tensor, w1, b1, w2, b2, ln_scale,
                              ln_bias, *, dropout_rate: float = 0.0,
                              eps: float = 1e-12) -> torch.Tensor:
    """The same block in plain PyTorch on any device."""
    _no_dropout(dropout_rate)
    h = x.shape[-1]
    x2 = x.reshape(-1, h)
    g = gemm_bias_act_reference(x2, w1, b1, act="gelu")
    y = layer_norm_reference(gemm_bias_residual_reference(g, w2, b2, x2),
                             ln_scale, ln_bias, eps, x.dtype)
    return y.reshape(x.shape)
