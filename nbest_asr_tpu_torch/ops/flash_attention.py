"""Flash attention for training -- the port of
``nbest_asr_tpu/ops/flash_attention.py:flash_attention`` (:590) and its
five Pallas bodies, on hand-written Hopper kernels (``ops/kernels.py``,
sources in ``csrc/``).

Layout and routing are JAX's: (b, s, heads, d) q, k, v in and out, a
(b, s) SEGMENT mask (0 = pad, k >= 1 = packed segment; a query attends
exactly the keys carrying its own value), ``sm_scale`` 1 / sqrt(d) unless
given.  Sequences up to ``SB_MAX_SEQ`` with no block size given take the
single-block route; a given ``block_q`` / ``block_k``, or a longer
sequence, forces the tiled route (the kernels keep their own 64-row
tiles, so the block sizes only route, as they change nothing in the
result).

==============================================  ==============================
TPU body                                        H100 kernel
==============================================  ==============================
``_sb_fwd_kernel`` (:364): per batch row, the   ``seg_attention``
heads' plain softmax, prob dropout, bf16 P.V    (``sb_attention``; saves the
                                                row max and sum)
``_sb_bwd_kernel`` (:380): probs recomputed,    ``seg_attention_bwd``
dv, di, ds, dq, dk                              (``sb_attention_bwd``: dQ,
                                                then dK/dV)
``_fwd_kernel`` (:99): online softmax over      ``flash_fwd`` (o, lse)
kv blocks
``_bwd_dq_kernel`` (:276) with di = sum(do*o)   ``flash_bwd_dq`` (di in its
(:499)                                          prologue)
``_bwd_dkv_kernel`` (:226)                      ``flash_bwd_dkv``
==============================================  ==============================

The three tiled kernels run on ``wgmma`` + TMA at d = 64 and 96 -- the
backward pair in 128-row blocks (two warpgroups fed 64-row tiles by a
producer warpgroup, or by warp 0 in the d = 96 dK/dV kernel), the forward
in 256-query blocks (four warpgroups, warp 0 filling the tile ring, the
online softmax in registers); every warpgroup draws its keep bits while
its score products run -- and on ``mma.sync`` at every other head dim
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``).  Both
routes take every head dim d >= 1, as JAX's ``flash_attention`` does: at
d <= 256 with d % 8 == 0 32, 96, 128, 192 and 256 on instances of their
own (the tiled kernels' 64 and 96 on ``wgmma``), any other such d on the
narrowest instance at least d wide, its columns past d zero-filled on
load and never stored; d > 256 and d % 8 != 0 on the chunked family
(``csrc/attention_chunked.cu``, ``kernels.chunked_head_dim``), the head
dim in 64-column chunks at any alignment.

The single-block bodies compute the function the attention megakernel's
head loop computes (``_sb_probs`` is ``_head_probs`` with a caller's
scale), which the port already runs on hand-written kernels; those
kernels read q, k and v by row stride, so they take the encoder's views
of its (n, 3h) QKV buffer and standalone (b, s, heads, d) tensors alike,
and a second copy would only duplicate them.  Nothing is padded or
transposed: the kernels exclude keys past the sequence end, which is
what JAX's -1 mask padding achieves (:622-642), and read the (b, s,
heads, d) layout through strides (JAX transposes at :658-660).

Prob dropout is Philox stream 3 keyed on (row = (elem * heads + head) *
s + q, column k) (``ops/philox.py``), the attention block's own mask, so
both routes and every tiling draw one mask per (seed, element), and each
backward regenerates the forward's.  JAX's 32-bit seed drawn from
``dropout_rng`` becomes an explicit integer ``seed`` (the encoder passes
``fold_in(layer seed, 1)``).  The TPU's bits cannot be reproduced, so
CPU parity with JAX is held at dropout 0.

Two autograd Functions carry the routes; on CPU tensors every step runs
its plain version (the device rule of ``ops/kernels.py``), and
``flash_attention_reference`` runs the same Functions on the plain
versions on any device.

Gradients.  q, k, v arriving as split views of one QKV buffer get
separate dq, dk, dv, which autograd's split backward concatenates: one
(n, 3h) copy a layer (``chip_smoke.py`` times it beside the kernels).
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels import chain_ops
from .philox import STREAM_ATTN_PROB, site

SB_MAX_SEQ = 512


class _SBCore(torch.autograd.Function):
    """The single-block route: ``seg_attention`` forward (saving the row
    max and sum), ``seg_attention_bwd`` backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask, sm_scale, drop, plain):
        ops = chain_ops(plain)
        o, st = ops.sb_attention(q, k, v, mask, sm_scale, drop, True)
        ctx.save_for_backward(q, k, v, mask, st)
        ctx.sm_scale, ctx.drop, ctx.plain = sm_scale, drop, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, st = ctx.saved_tensors
        dq, dk, dv = chain_ops(ctx.plain).sb_attention_bwd(
            q, k, v, do.contiguous(), mask, st, ctx.sm_scale, ctx.drop)
        return dq, dk, dv, None, None, None, None


class _FlashCore(torch.autograd.Function):
    """The tiled route: ``flash_fwd`` forward (saving o and lse),
    ``flash_bwd_dq`` then ``flash_bwd_dkv`` backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask, sm_scale, drop, plain):
        o, lse = chain_ops(plain).flash_fwd(q, k, v, mask, sm_scale, drop)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.sm_scale, ctx.drop, ctx.plain = sm_scale, drop, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        ops = chain_ops(ctx.plain)
        do = do.contiguous()
        dq, di = ops.flash_bwd_dq(q, k, v, mask, o, lse, do, ctx.sm_scale,
                                  ctx.drop)
        dk, dv = ops.flash_bwd_dkv(q, k, v, mask, lse, di, do, ctx.sm_scale,
                                   ctx.drop)
        return dq, dk, dv, None, None, None, None


def _shared_rows(q, k, v):
    """q, k, v as given if they share one row layout (rows of heads x d
    contiguous values, one stride: e.g. views of one QKV buffer), else
    contiguous copies."""
    b, s, nh, d = q.shape

    def rows_ok(t, ld):
        want = (s * ld, ld, d, 1)
        return t.shape == q.shape and all(
            st == w or n == 1 for st, w, n in zip(t.stride(), want, t.shape))

    ld = q.stride(1) if s > 1 else q.stride(0)
    if all(rows_ok(t, ld) for t in (q, k, v)):
        return q, k, v
    return q.contiguous(), k.contiguous(), v.contiguous()


def _flash(q, k, v, attn_mask, sm_scale, block_q, block_k, dropout_rate,
           seed, plain):
    b, s, nh, d = q.shape
    dropout_rate = float(dropout_rate)
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("flash_attention: dropout_rate > 0 requires seed")
    drop = site(seed, dropout_rate, STREAM_ATTN_PROB)
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    mask = attn_mask.to(torch.float32).contiguous()
    q, k, v = _shared_rows(q, k, v)
    core = _SBCore if (s <= SB_MAX_SEQ and block_q is None
                       and block_k is None) else _FlashCore
    return core.apply(q, k, v, mask, float(sm_scale), drop, plain)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attn_mask: torch.Tensor, sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    dropout_rate: float = 0.0,
                    seed: Optional[int] = None) -> torch.Tensor:
    """(b, s, heads, d) q, k, v + (b, s) SEGMENT mask -> (b, s, heads, d)
    in q's dtype.  ``dropout_rate > 0`` drops the attention probs with
    the Philox mask of ``seed`` (required then).  CUDA tensors (bf16, any
    head dim d >= 1 on both routes; d > 256 and d % 8 != 0 on the chunked
    family) run the kernels; CPU tensors their plain versions."""
    return _flash(q, k, v, attn_mask, sm_scale, block_q, block_k,
                  dropout_rate, seed, plain=False)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, attn_mask: torch.Tensor,
                              sm_scale: Optional[float] = None,
                              block_q: Optional[int] = None,
                              block_k: Optional[int] = None,
                              dropout_rate: float = 0.0,
                              seed: Optional[int] = None) -> torch.Tensor:
    """``flash_attention``, forward and backward, on the plain versions
    of its kernels on any device, with the same Philox masks."""
    return _flash(q, k, v, attn_mask, sm_scale, block_q, block_k,
                  dropout_rate, seed, plain=True)
