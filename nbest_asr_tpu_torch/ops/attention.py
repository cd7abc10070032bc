"""Multi-head self-attention: the plain path and the flash route -- the
port of ``nbest_asr_tpu/ops/attention.py:multi_head_attention``.

SEGMENT-mask semantics: ``attn_mask`` (b, s) holds 0 for pads and k >= 1
for the packed segment a position belongs to; a query attends exactly the
keys that carry its own mask value.  A plain 1/0 padding mask keeps its
usual meaning, a multi-valued mask gives the block-diagonal attention of
example packing, and pad positions attend each other (their outputs are
never read).  Logits are f32 and masked with -1e9.  In training the
probabilities take dropout in f32 before their cast to the value dtype
(``attention.py:161-164``), with the mask drawn from ``gen``.

``use_flash=True`` sends a training call to ``ops/flash_attention.py``
exactly where JAX's ``multi_head_attention`` (:138-147) sends it to its
Pallas kernels: not deterministic, the (static) seq at or above the
effective ``flash_min_seq``, and ``_flash_preferred`` -- always up to the
single-block ceiling of 512, above it only where the plain path's ~3
(b, heads, s, s) backward buffers would pass 2 GiB.  Eval and serving
never take it.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .layers import acc_dtype, dropout

# JAX's routing constants and predicate (nbest_asr_tpu/ops/attention.py
# :40-76): NBEST_FLASH_MIN_SEQ, read at each call, wins over the config
DEFAULT_FLASH_MIN_SEQ = 160
_XLA_ATTN_RESIDENCY_BUDGET = 2 * 2 ** 30


def effective_flash_min_seq(cfg_value=None) -> int:
    env = os.environ.get("NBEST_FLASH_MIN_SEQ")
    if env is not None:
        return int(env)
    return DEFAULT_FLASH_MIN_SEQ if cfg_value is None else int(cfg_value)


def _flash_preferred(b: int, s: int, h: int, itemsize: int = 2) -> bool:
    """Flash at (batch, seq, heads): single-block territory (s <= 512)
    always; tiled territory only where the plain path's ~3x (b, h, s, s)
    backward residency at ``itemsize`` bytes passes the budget."""
    from .flash_attention import SB_MAX_SEQ

    if s <= SB_MAX_SEQ:
        return True
    return 3 * b * h * s * s * itemsize > _XLA_ATTN_RESIDENCY_BUDGET


def flash_routes(q_shape, itemsize: int, *, use_flash: bool,
                 deterministic: bool, flash_min_seq=None) -> bool:
    """JAX's ``multi_head_attention`` takes its flash kernels for q of
    shape (b, s, heads, d) at ``itemsize`` bytes a value."""
    return (use_flash and not deterministic
            and q_shape[1] >= effective_flash_min_seq(flash_min_seq)
            and _flash_preferred(*q_shape[:3], itemsize))


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attn_mask: torch.Tensor, *,
                         dropout_rate: float = 0.0,
                         gen: Optional[torch.Generator] = None,
                         seed: Optional[int] = None,
                         deterministic: bool = True,
                         use_flash: bool = False,
                         flash_min_seq: Optional[int] = None
                         ) -> torch.Tensor:
    """q, k, v (b, s, n_heads, d_head) -> (b, s, n_heads, d_head).  The
    plain path draws its dropout from ``gen``; the flash route from the
    Philox ``seed`` (JAX's one ``dropout_rng`` serves both)."""
    if flash_routes(q.shape, q.element_size(), use_flash=use_flash,
                    deterministic=deterministic,
                    flash_min_seq=flash_min_seq):
        from .flash_attention import flash_attention

        if dropout_rate > 0.0:
            return flash_attention(q, k, v, attn_mask,
                                   dropout_rate=dropout_rate, seed=seed)
        return flash_attention(q, k, v, attn_mask)
    d = q.shape[-1]
    acc = acc_dtype(q.dtype)
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=acc))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) \
        * scale.to(q.device)
    m = attn_mask.to(acc)
    same_seg = m[:, None, None, :] == m[:, None, :, None]
    logits = torch.where(same_seg, logits,
                         torch.tensor(-1e9, dtype=acc, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    probs = dropout(probs, dropout_rate, gen, deterministic).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(acc), v.to(acc))
    return out.to(q.dtype)
