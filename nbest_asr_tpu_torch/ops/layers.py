"""Elementary encoder ops in plain PyTorch -- counterparts of
``nbest_asr_tpu/ops/layers.py`` and the port's oracles for its kernels.

``dropout`` draws its mask from an explicit ``torch.Generator`` (the JAX
package draws it from a key); the kernels' dropout is the Philox scheme
of ``ops/philox.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

INV_SQRT2 = 1.0 / math.sqrt(2.0)
INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


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
    return (x32 * 0.5 * (1.0 + torch.erf(x32 * INV_SQRT2))).to(x.dtype)


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d gelu_erf / dx = cdf + x * pdf, in x's dtype, in the order of
    ``nbest_asr_tpu/ops/fused_ffn.py:_gelu_grad_f32``."""
    cdf = 0.5 * (1.0 + torch.erf(x * INV_SQRT2))
    pdf = torch.exp(-0.5 * x * x) * INV_SQRT2PI
    return cdf + x * pdf


def layer_norm_stats(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-12):
    """LayerNorm over the last axis in (at least) f32 -> (y in the
    accumulation dtype, mean, rstd), the statistics with a kept last
    axis of 1."""
    acc = acc_dtype(x.dtype)
    x32 = x.to(acc)
    mean = x32.mean(dim=-1, keepdim=True)
    c = x32 - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return c * rstd * scale.to(acc) + bias.to(acc), mean, rstd


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last axis with (at least) f32 statistics."""
    return layer_norm_stats(x, scale, bias, eps)[0].to(x.dtype)


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
            deterministic: bool = False) -> torch.Tensor:
    """Inverted dropout with its mask drawn from ``gen``: kept values are
    divided by keep = 1 - rate, as ``nbest_asr_tpu/ops/layers.py:56``
    does (the kernels multiply by 1 / keep instead, as the TPU kernels
    do)."""
    if deterministic or rate == 0.0:
        return x
    if gen is None:
        raise ValueError("dropout: rate > 0 needs a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def gather_index(idx: torch.Tensor, n: int):
    """XLA's gather of ``idx`` into a table of n rows -> (the index the
    forward reads, clamped into [0, n); whether the backward's scatter-add
    keeps that element's gradient, i.e. the index was inside the table).
    A negative index counts from the end once, as JAX's indexing does."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    rows_idx = idx.clamp(0, n - 1)
    return rows_idx, rows_idx == idx


def scatter_rows(n: int, rows_idx: torch.Tensor, inside: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """XLA's scatter-add of ``g``'s rows into a table of n rows at
    ``gather_index``'s indices: an out-of-range id's row goes to a spare
    row past the table and is dropped.  Ordered (``index_put_``), no
    atomics."""
    d = g.new_zeros((n + 1,) + g.shape[rows_idx.dim():])
    d.index_put_((torch.where(inside, rows_idx, n),), g, accumulate=True)
    return d[:n]


class _TakeRows(torch.autograd.Function):
    """XLA's gather and its transpose: the forward reads the clamped rows
    (zero rows where ``read`` is given and false), the backward is
    ``scatter_rows``."""

    @staticmethod
    def forward(ctx, table, rows_idx, inside, read=None):
        ctx.save_for_backward(rows_idx, inside)
        ctx.n = table.shape[0]
        rows = table[rows_idx]
        if read is not None:
            rows = torch.where(read[..., None], rows, rows.new_zeros(()))
        return rows

    @staticmethod
    def backward(ctx, g):
        return scatter_rows(ctx.n, *ctx.saved_tensors, g), None, None, None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` as JAX's gather computes it (``gather_index``): an
    out-of-range id -- a segment id 1 into RoBERTa's one-row type table,
    an added token past a checkpoint's vocab, a position past the table
    -- reads the nearest row where torch would raise, and trains
    nothing."""
    return _TakeRows.apply(table, *gather_index(idx, table.shape[0]))


def take_rows_shard(shard: torch.Tensor, idx: torch.Tensor, n: int,
                    lo: int) -> torch.Tensor:
    """This rank's part of ``take_rows`` of a table of n rows of which
    ``shard`` holds rows [lo, lo + len(shard)) (the vocab-parallel word
    table, ``parallel/mesh.py``): the rows the shard holds, zero rows for
    the others, so that the sum over the shards is ``take_rows``' result;
    the backward keeps the gradient of in-range ids in this shard
    alone."""
    rows_idx, inside = gather_index(idx, n)
    local = rows_idx - lo
    mine = (local >= 0) & (local < shard.shape[0])
    return _TakeRows.apply(shard, torch.where(mine, local, 0),
                           inside & mine, mine)
