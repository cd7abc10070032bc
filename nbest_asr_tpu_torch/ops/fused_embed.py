"""Fused embedding lookup -- the port of
``nbest_asr_tpu/ops/fused_embed.py:fused_embed_lookup`` (:116): word +
position + token-type rows and LayerNorm in one pass, on the hand-written
``embed_lookup`` kernel (``csrc/fused_embed.cu``) that replaces the
Pallas body ``_embed_kernel`` (:48).

JAX's contract: (b, s) ids -> (b, s, h) in the word table's dtype; the
position row of flat token row t is ``t mod seq_len`` of a table the
caller has already sliced at its position offset; ``b * s`` must be a
multiple of 8 (the JAX packer guarantees it; both packages refuse the
same inputs).  ``type_ids`` None reads type row 0 for every token, where
JAX passes zeros.

The backward is plain PyTorch, as JAX's is XLA (``_bwd``, :172): the
LayerNorm backward on the recomputed f32 sum, then scatter-adds into the
three tables and the column sums for scale and bias.  Out-of-range ids
follow JAX on both sides, which disagree: the forward reads a zero row
for a type id outside its table or a word id in the table's padding to
a multiple of 8 (its one-hot selects), the backward recomputes with the
row at the clamped id and drops that id's gradient (XLA's gather and its
scatter-add).  The scatter-adds
are ``index_put_(accumulate=True)``, which CUDA sums in a fixed order
(sorted indices), as the plain path's ``word[ids]`` backward does:
``index_add_`` adds with atomics, and its run-to-run noise made the
training loss of two identical runs differ.
CUDA tensors run the kernel forward; CPU tensors its plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels as K
from .layers import gather_index, scatter_rows

BN = 8  # JAX's token rows per grid step: b * s must be a multiple


def _embed_grads(word, pos, type_, scale, ids, type_ids, seq_len: int,
                 eps: float, dy):
    """Gradients of the five tables and LN parameters, in f32, of JAX's
    XLA formulation (``_xla_embed``): its gathers read out-of-range ids
    clamped, its scatter-adds drop their gradients."""
    n = ids.shape[0]
    ids, w_in = gather_index(ids, word.shape[0])
    t_in = None
    if type_ids is not None:
        type_ids, t_in = gather_index(type_ids, type_.shape[0])
    rows = torch.arange(n, device=ids.device) % seq_len
    t = type_[0] if type_ids is None else type_[type_ids]
    x = word[ids].float() + pos[rows].float() + t.float()
    mean = x.mean(dim=-1, keepdim=True)
    c = x - mean
    rstd = torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    xhat = c * rstd
    d = dy.float()
    g = d * scale.float()
    dx = (g - g.mean(dim=-1, keepdim=True)
          - xhat * (g * xhat).mean(dim=-1, keepdim=True)) * rstd
    dword = scatter_rows(word.shape[0], ids, w_in, dx)
    dpos = torch.zeros(pos.shape, dtype=torch.float32,
                       device=dx.device).index_put_((rows,), dx,
                                                    accumulate=True)
    if type_ids is None:
        dtype_ = torch.zeros(type_.shape, dtype=torch.float32,
                             device=dx.device)
        dtype_[0] = dx.sum(dim=0)
    else:
        dtype_ = scatter_rows(type_.shape[0], type_ids, t_in, dx)
    return dword, dpos, dtype_, (d * xhat).sum(dim=0), d.sum(dim=0)


class _EmbedLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, word, pos, type_, scale, bias, ids, type_ids, seq_len,
                eps):
        dev_ids = ids.to(torch.int32)
        dev_tids = None if type_ids is None else type_ids.to(torch.int32)
        out = K.embed_lookup(word, pos, type_, scale, bias, dev_ids,
                             dev_tids, seq_len, eps)
        ctx.save_for_backward(word, pos, type_, scale, bias, ids,
                              type_ids)
        ctx.seq_len, ctx.eps = seq_len, eps
        return out

    @staticmethod
    def backward(ctx, dy):
        word, pos, type_, scale, bias, ids, type_ids = ctx.saved_tensors
        grads = _embed_grads(word, pos, type_, scale, ids.long(),
                             None if type_ids is None else type_ids.long(),
                             ctx.seq_len, ctx.eps, dy)
        out = [g.to(t.dtype) for g, t in zip(
            grads, (word, pos, type_, scale, bias))]
        return (*out, None, None, None, None)


def fused_embed_lookup(word: torch.Tensor, pos: torch.Tensor,
                       type_: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, ids: torch.Tensor,
                       type_ids: Optional[torch.Tensor], seq_len: int,
                       eps: float = 1e-12) -> torch.Tensor:
    """(b, s) int ids -> (b, s, h) normalized embeddings in the word
    table's dtype.  ``pos`` is the position table sliced at the position
    offset; position row = (flat row index mod ``seq_len``)."""
    b, s = ids.shape
    n = b * s
    if n % BN:
        raise ValueError(f"fused_embed_lookup: rows {n} must be a multiple "
                         f"of {BN}")
    tids = None if type_ids is None else type_ids.reshape(n)
    out = _EmbedLookup.apply(word, pos, type_, scale, bias, ids.reshape(n),
                             tids, int(seq_len), float(eps))
    return out.reshape(b, s, word.shape[1])
