"""Decode rule -- the port of ``nbest_asr_tpu/train/decode.py``.

- a top group fires when its score exceeds 0.5;
- a singleton group emits its sole bottom label;
- a multi-member group emits its within-group argmax (ties go to the
  first index), except labels ending in ``NONE``.
"""

from __future__ import annotations

from typing import Dict

import torch


def decode_multihot(top_scores: torch.Tensor, bottom_probs: torch.Tensor,
                    hier: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(b, n_top) scores + (b, n_bottom) group softmax -> (b, n_bottom)
    bool predictions."""
    b2t = hier["bottom2top"]
    active_top = top_scores > 0.5
    pred_single = active_top[:, b2t] & (hier["singleton_onehot"] > 0)

    membership = hier["membership"]
    masked = torch.where(membership[None, :, :] > 0,
                         bottom_probs[:, None, :].float(),
                         torch.tensor(-1.0, device=bottom_probs.device))
    # torch.argmax returns the first maximal index, as jnp.argmax does
    winner = masked.argmax(dim=-1)                      # (b, n_top)
    n_bottom = bottom_probs.shape[1]
    onehot = torch.nn.functional.one_hot(winner, n_bottom).bool()
    fire = active_top & hier["is_multi_top"][None, :]
    pred_multi = (onehot & fire[:, :, None]).any(dim=1)
    pred_multi = pred_multi & ~hier["is_none_bottom"][None, :]
    return pred_single | pred_multi
