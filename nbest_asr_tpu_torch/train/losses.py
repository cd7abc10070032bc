"""Compound loss stack -- the port of ``nbest_asr_tpu/train/losses.py``.

1. bottom BCE, sum reduction, on ``final_scores`` vs the multi-hot labels;
2. top BCE, sum reduction, on ``top_scores`` vs ``labels @ bottom2top_mat``
   -- the matmul target is kept unclamped (two gold bottoms sharing a top
   give target 2.0, as in the reference);
3. per-group CE over the multi-member groups: the gold member's
   ``log(group_softmax + 1e-12)``, an empty group hitting its last member
   (NONE), averaged over groups; multi-gold rows generalise as in JAX
   (``losses.py:16-25``);
4. optional MSE (mean) between the ASR and transcript [CLS] vectors
   (``add_l2_loss``), the one term that is not a sum over rows.

The log terms clamp at -100 as torch's BCELoss does, and the clamp is
gradient-safe: where it is active the log's input is replaced before the
log (the double-where of ``losses.py:57-68``), so the gradient is exactly
0 at saturated probabilities instead of 0 * inf = NaN.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..ops.layers import acc_dtype

# exp(-100): below this the -100 clamp is active and the gradient must be
# cut before the log
_LOG_CLAMP_TINY = 3.7200760e-44


def _safe_log(p: torch.Tensor) -> torch.Tensor:
    """max(log(p), -100) with a NaN-free gradient (0 where clamped)."""
    ok = p > _LOG_CLAMP_TINY
    ps = torch.where(ok, p, torch.ones_like(p))
    return torch.where(ok, torch.clamp(torch.log(ps), min=-100.0),
                       torch.full_like(p, -100.0))


def _safe_log1m(p: torch.Tensor) -> torch.Tensor:
    """max(log1p(-p), -100) with a NaN-free gradient."""
    ok = (1.0 - p) > _LOG_CLAMP_TINY
    ps = torch.where(ok, p, torch.zeros_like(p))
    return torch.where(ok, torch.clamp(torch.log1p(-ps), min=-100.0),
                       torch.full_like(p, -100.0))


@dataclass(frozen=True)
class LossConfig:
    add_l2_loss: bool = False


def total_loss(top_scores: torch.Tensor, bottom_probs: torch.Tensor,
               final_scores: torch.Tensor, labels: torch.Tensor,
               hier: Dict[str, torch.Tensor], cfg: LossConfig,
               asr_cls: Optional[torch.Tensor] = None,
               trans_cls: Optional[torch.Tensor] = None,
               example_mask: Optional[torch.Tensor] = None,
               mse_rows: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (total, parts).  ``example_mask`` (b,) zeroes padding rows of
    fixed-shape batches.  Parts stay device scalars: the caller reads
    them once per epoch, not once per step.  Every term but the MSE sums
    over rows; ``mse_rows`` is the number of rows the MSE averages over
    when this call sees only some of them (a data-parallel rank's rows of
    a global micro), by default this call's real rows."""
    parts: Dict[str, torch.Tensor] = {}
    em = None if example_mask is None else example_mask.to(torch.float32)

    def masked_sum(rows):
        return rows.sum() if em is None else (rows * em).sum()

    acc = acc_dtype(final_scores.dtype)
    p = final_scores.to(acc)
    t = labels.to(acc)
    row_bce = -(t * _safe_log(p) + (1 - t) * _safe_log1m(p)).sum(dim=1)
    bottom = masked_sum(row_bce)
    parts["bottom_bce"] = bottom

    top_targets = t @ hier["bottom2top_mat"].to(acc)
    tp = top_scores.to(acc)
    row_top = -(top_targets * _safe_log(tp)
                + (1 - top_targets) * _safe_log1m(tp)).sum(dim=1)
    top = masked_sum(row_top)
    parts["top_bce"] = top

    if em is not None:
        lbl = t * example_mask[:, None]
    else:
        lbl = t
    logp = torch.log(bottom_probs.to(acc) + 1e-12)
    M = hier["membership"].to(acc)
    picked = torch.einsum("bn,tn->bt", lbl * logp, M)
    has_gold = torch.einsum("bn,tn->bt", lbl, M)
    last_logp = logp[:, hier["group_last_bottom"]]
    per_group = -(picked + (1.0 - has_gold) * last_logp)
    if em is not None:
        per_group = per_group * example_mask[:, None]
    multi = hier["is_multi_top"].to(torch.float32)
    ce = (per_group.sum(dim=0) * multi).sum() / multi.sum()
    parts["group_ce"] = ce

    total = bottom + top + ce
    if cfg.add_l2_loss and asr_cls is not None and trans_cls is not None:
        diff = (asr_cls - trans_cls).to(acc)
        if em is not None:
            diff = diff * example_mask[:, None]
        if mse_rows is not None:
            denom = torch.clamp(mse_rows.to(acc), min=1.0) * diff.shape[1]
        elif em is not None:
            denom = torch.clamp(em.sum(), min=1.0) * diff.shape[1]
        else:
            denom = diff.shape[0] * diff.shape[1]
        mse = (diff * diff).sum() / denom
        parts["mse"] = mse
        total = total + mse
    parts["total"] = total
    return total, parts
