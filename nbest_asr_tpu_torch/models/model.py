"""Full model: encoder + hierarchical classifier -- the single-stream
port of ``nbest_asr_tpu/models/model.py``.

The serving forward encodes the ASR input only; the transcript stream of
training (the shared-weight second encoder pass) lands with the training
slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..ops.layers import acc_dtype
from .encoder import EncoderConfig, encoder_forward, init_encoder_params
from .heads import hierarchical_head, init_head_params


@dataclass(frozen=True)
class ModelConfig:
    encoder: EncoderConfig
    n_top: int
    n_bottom: int
    head_dropout: float = 0.0

    @property
    def hidden(self) -> int:
        return self.encoder.hidden_size


def init_model_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {
        "encoder": init_encoder_params(gen, cfg.encoder),
        "head": init_head_params(gen, cfg.hidden, cfg.n_top, cfg.n_bottom),
    }


def model_forward(params: dict, cfg: ModelConfig,
                  hier: Dict[str, torch.Tensor], input_ids: torch.Tensor,
                  attn_mask: torch.Tensor,
                  token_type_ids: Optional[torch.Tensor] = None, *,
                  position_ids: Optional[torch.Tensor] = None,
                  cls_positions: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Deterministic forward -> (top_scores, bottom_probs, final_scores,
    cls).

    EXAMPLE PACKING: ``cls_positions`` (b, n_seg) holds each packed
    segment's [CLS] offset; the per-segment CLS vectors are gathered and
    flattened to (b * n_seg, h), one row per utterance.  Without it the
    CLS vector is position 0 of each row."""
    seq = encoder_forward(params["encoder"], input_ids, attn_mask,
                          token_type_ids, cfg.encoder,
                          position_ids=position_ids)
    acc = acc_dtype(seq.dtype)
    if cls_positions is None:
        cls = seq[:, 0, :].to(acc)
    else:
        idx = cls_positions.long()[:, :, None].expand(-1, -1, seq.shape[-1])
        cls = torch.gather(seq, 1, idx).reshape(-1, seq.shape[-1]).to(acc)
    top, probs, final = hierarchical_head(params["head"], cls, hier)
    return top, probs, final, cls
