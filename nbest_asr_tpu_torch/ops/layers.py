"""Elementary encoder ops in plain PyTorch -- counterparts of
``nbest_asr_tpu/ops/layers.py`` and the port's oracles for its kernels.

Dropout waits for the training slice: the serving forward is
deterministic.
"""

from __future__ import annotations

import math

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: at least f32 (bf16 accumulates in f32, f64
    stays f64)."""
    return torch.promote_types(dtype, torch.float32)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor
          ) -> torch.Tensor:
    """y = x @ kernel + bias with kernel laid out (in, out), accumulated
    in f32 and rounded once to the input dtype."""
    acc = acc_dtype(x.dtype)
    y = torch.matmul(x.to(acc), kernel.to(acc))
    return (y + bias.to(acc)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, computed in the input dtype's accumulation type."""
    acc = acc_dtype(x.dtype)
    x32 = x.to(acc)
    return (x32 * 0.5 * (1.0 + torch.erf(x32 * (1.0 / math.sqrt(2.0))))
            ).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last axis with (at least) f32 statistics."""
    acc = acc_dtype(x.dtype)
    x32 = x.to(acc)
    mean = x32.mean(dim=-1, keepdim=True)
    c = x32 - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + eps)
    return (y * scale.to(acc) + bias.to(acc)).to(x.dtype)
