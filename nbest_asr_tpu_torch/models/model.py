"""Full model: encoder + hierarchical classifier -- the port of
``nbest_asr_tpu/models/model.py``.

The forward encodes the ASR input and, when ``trans_input_ids`` are
given, the manual-transcript input with the same shared encoder weights
(the second stream that ``LossConfig(add_l2_loss=True)`` compares), takes
each stream's [CLS] vector and feeds the selected one to the classifier.
Training (``deterministic=False``) needs a ``seed``: the ASR pass, the
transcript pass and the head each take their own seed from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..ops.layers import acc_dtype
from ..ops.philox import fold_in
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


def _take_cls(seq: torch.Tensor, positions: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """The [CLS] vector of each row, or (example packing) of each packed
    segment at ``positions`` (b, n_seg), flattened to one row per
    utterance."""
    acc = acc_dtype(seq.dtype)
    if positions is None:
        return seq[:, 0, :].to(acc)
    idx = positions.long()[:, :, None].expand(-1, -1, seq.shape[-1])
    return torch.gather(seq, 1, idx).reshape(-1, seq.shape[-1]).to(acc)


def model_forward(params: dict, cfg: ModelConfig,
                  hier: Dict[str, torch.Tensor], input_ids: torch.Tensor,
                  attn_mask: torch.Tensor,
                  token_type_ids: Optional[torch.Tensor] = None,
                  trans_input_ids: Optional[torch.Tensor] = None,
                  trans_attn_mask: Optional[torch.Tensor] = None,
                  trans_token_type_ids: Optional[torch.Tensor] = None, *,
                  classifier_input_type: str = "asr",
                  deterministic: bool = True, seed: Optional[int] = None,
                  position_ids: Optional[torch.Tensor] = None,
                  trans_position_ids: Optional[torch.Tensor] = None,
                  cls_positions: Optional[torch.Tensor] = None,
                  trans_cls_positions: Optional[torch.Tensor] = None,
                  mesh=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, Optional[torch.Tensor]]:
    """-> (top_scores, bottom_probs, final_scores, asr_cls, trans_cls);
    trans_cls is None without the transcript stream.

    EXAMPLE PACKING: ``cls_positions`` (b, n_seg) holds each packed
    segment's [CLS] offset; the per-segment CLS vectors are gathered and
    flattened to (b * n_seg, h), one row per utterance.  Without it the
    CLS vector is position 0 of each row.  ``mesh`` runs the encoder
    tensor-parallel (``encoder_forward``); the head is replicated."""
    if not deterministic and seed is None:
        raise ValueError("model_forward: deterministic=False requires a "
                         "seed")
    r_asr = r_trans = r_head = None
    if not deterministic:
        r_asr, r_trans, r_head = (fold_in(seed, i) for i in range(3))
    seq = encoder_forward(params["encoder"], input_ids, attn_mask,
                          token_type_ids, cfg.encoder,
                          deterministic=deterministic, seed=r_asr,
                          position_ids=position_ids, mesh=mesh)
    asr_cls = _take_cls(seq, cls_positions)
    trans_cls = None
    if trans_input_ids is not None:
        tseq = encoder_forward(params["encoder"], trans_input_ids,
                               trans_attn_mask, trans_token_type_ids,
                               cfg.encoder, deterministic=deterministic,
                               seed=r_trans,
                               position_ids=trans_position_ids, mesh=mesh)
        trans_cls = _take_cls(tseq, trans_cls_positions)
    feats = trans_cls if (classifier_input_type == "transcript"
                          and trans_cls is not None) else asr_cls
    top, probs, final = hierarchical_head(
        params["head"], feats, hier, dropout_rate=cfg.head_dropout,
        seed=r_head, deterministic=deterministic)
    return top, probs, final, asr_cls, trans_cls
