"""Hierarchical semantic-tuple classifier in PyTorch -- the port of
``nbest_asr_tpu/models/heads.py``.

One dense (h, n_bottom) product plus a group-masked softmax driven by the
membership matrix of the label hierarchy:

- top head:    sigmoid(x @ W_top + b_top)              -> (b, n_top)
- bottom head: x @ W_bot + b_bot                       -> (b, n_bottom)
- softmax within each top group's members
- final[b, j] = top[b, g(j)] * softmax_j   for multi-member groups
                top[b, g(j)]               for singleton groups

In training (``deterministic=False`` with a ``seed``) the head drops the
CLS features once for the top head and with an independent (b, h) mask
per top group for the bottom projection, as ``heads.py:91-126`` does
(the reference calls its dropout afresh for every group head).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..data.vocab import HierarchyArrays
from ..ops.layers import acc_dtype, dropout
from ..ops.philox import fold_in, generator


def init_head_params(gen: torch.Generator, hidden: int, n_top: int,
                     n_bottom: int) -> dict:
    """torch ``nn.Linear``'s default: U(+-1/sqrt(fan_in)) for kernel and
    bias, kernels laid out (in, out)."""
    bound = 1.0 / math.sqrt(hidden)

    def u(*shape):
        t = torch.empty(shape, dtype=torch.float32, device=gen.device)
        return torch.nn.init.uniform_(t, -bound, bound, generator=gen)

    return {
        "top_kernel": u(hidden, n_top),
        "top_bias": u(n_top),
        "bottom_kernel": u(hidden, n_bottom),
        "bottom_bias": u(n_bottom),
    }


def group_softmax(logits: torch.Tensor, membership: torch.Tensor,
                  bottom2top: torch.Tensor) -> torch.Tensor:
    """Softmax over the bottom axis within each top group; (b, n_bottom)
    f32 logits in, each group's members summing to 1 out."""
    neg = torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
    masked = torch.where(membership[None, :, :] > 0, logits[:, None, :], neg)
    gmax = masked.amax(dim=-1)                       # (b, n_top)
    e = torch.exp(logits - gmax[:, bottom2top])
    denom = torch.einsum("bn,tn->bt", e, membership)
    return e / denom[:, bottom2top]


def hierarchical_head(params: dict, features: torch.Tensor,
                      hier: Dict[str, torch.Tensor], *,
                      dropout_rate: float = 0.0, seed: Optional[int] = None,
                      deterministic: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """features (b, h) -> (top_scores (b, n_top), bottom_probs
    (b, n_bottom), final_scores (b, n_bottom))."""
    f = features.to(acc_dtype(features.dtype))
    f_top, bottom_logits = f, None
    if not deterministic and dropout_rate > 0.0:
        if seed is None:
            raise ValueError("hierarchical_head: dropout needs a seed")
        f_top = dropout(f, dropout_rate,
                        generator(fold_in(seed, 1), f.device))
        n_top = params["top_kernel"].shape[1]
        n_bottom = params["bottom_kernel"].shape[1]
        keep = 1.0 - dropout_rate
        masks = torch.rand((n_top,) + tuple(f.shape), device=f.device,
                           generator=generator(fold_in(seed, 2),
                                               f.device)) < keep
        dropped = torch.where(masks, f[None] / keep,
                              torch.zeros((), dtype=f.dtype,
                                          device=f.device))
        logits_all = (torch.einsum("gbh,hn->gbn", dropped,
                                   params["bottom_kernel"])
                      + params["bottom_bias"])          # (g, b, n_bottom)
        bottom_logits = logits_all[
            hier["bottom2top"], :,
            torch.arange(n_bottom, device=f.device)].T
    top = torch.sigmoid(f_top @ params["top_kernel"] + params["top_bias"])
    if bottom_logits is None:
        bottom_logits = f @ params["bottom_kernel"] + params["bottom_bias"]
    probs = group_softmax(bottom_logits, hier["membership"],
                          hier["bottom2top"])
    top_per_bottom = top[:, hier["bottom2top"]]
    multi_per_bottom = hier["is_multi_top"][hier["bottom2top"]]
    final = torch.where(multi_per_bottom, top_per_bottom * probs,
                        top_per_bottom)
    return top, probs, final


def hierarchy_device_arrays(arrays: HierarchyArrays,
                            device="cpu") -> Dict[str, torch.Tensor]:
    """numpy hierarchy arrays -> tensors on ``device`` for the head and
    decode (index arrays as int64, flags as bool)."""
    def t(a, dtype):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return {
        "membership": t(arrays.membership, torch.float32),
        "bottom2top": t(arrays.bottom2top, torch.long),
        "bottom2top_mat": t(arrays.bottom2top_mat, torch.float32),
        "is_multi_top": t(arrays.is_multi_top, torch.bool),
        "group_last_bottom": t(arrays.group_last_bottom, torch.long),
        "is_none_bottom": t(arrays.is_none_bottom, torch.bool),
        "singleton_onehot": t(arrays.singleton_onehot, torch.float32),
    }
