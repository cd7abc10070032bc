"""Plain multi-head self-attention -- the XLA branch of
``nbest_asr_tpu/ops/attention.py:multi_head_attention``.

SEGMENT-mask semantics: ``attn_mask`` (b, s) holds 0 for pads and k >= 1
for the packed segment a position belongs to; a query attends exactly the
keys that carry its own mask value.  A plain 1/0 padding mask keeps its
usual meaning, a multi-valued mask gives the block-diagonal attention of
example packing, and pad positions attend each other (their outputs are
never read).  Logits are f32 and masked with -1e9.  In training the
probabilities take dropout in f32 before their cast to the value dtype
(``attention.py:161-164``), with the mask drawn from ``gen``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .layers import acc_dtype, dropout


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attn_mask: torch.Tensor, *,
                         dropout_rate: float = 0.0,
                         gen: Optional[torch.Generator] = None,
                         deterministic: bool = True) -> torch.Tensor:
    """q, k, v (b, s, n_heads, d_head) -> (b, s, n_heads, d_head)."""
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
