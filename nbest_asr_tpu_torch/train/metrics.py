"""Metrics: micro tuple-F1 and exact-match accuracy -- the port of
``nbest_asr_tpu/train/metrics.py``.

- device path: TP / FP / FN / exact-match counters from the decoded
  multi-hot against the gold multi-hot, summed on the device inside the
  train step (the training-time monitor);
- host path: string-level ``update_f1`` / ``compute_f1`` over the raw
  gold label strings (the reported eval numbers), with the optional
  ontology filter.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def f1_counts_from_multihot(pred: torch.Tensor, gold: torch.Tensor,
                            example_mask: Optional[torch.Tensor] = None
                            ) -> Dict[str, torch.Tensor]:
    """pred / gold (b, n_bottom) {bool, 0/1} -> dict of scalar f32
    counts."""
    p = pred.to(torch.float32)
    g = gold.to(torch.float32)
    tp_rows = (p * g).sum(dim=1)
    fp_rows = (p * (1 - g)).sum(dim=1)
    fn_rows = ((1 - p) * g).sum(dim=1)
    exact_rows = (p == g).all(dim=1).to(torch.float32)
    ones = torch.ones_like(tp_rows)
    if example_mask is not None:
        em = example_mask.to(torch.float32)
        tp_rows, fp_rows, fn_rows = tp_rows * em, fp_rows * em, fn_rows * em
        exact_rows = exact_rows * em
        ones = em
    return {"tp": tp_rows.sum(), "fp": fp_rows.sum(), "fn": fn_rows.sum(),
            "correct": exact_rows.sum(), "total": ones.sum()}


def update_f1(pred: Sequence[str], gold: Sequence[str],
              TP: int, FP: int, FN: int) -> Tuple[int, int, int]:
    """Duplicates in gold count twice (reference `utils/fscore.py:2-11`)."""
    for term in pred:
        if term in gold:
            TP += 1
        else:
            FP += 1
    for term in gold:
        if term not in pred:
            FN += 1
    return TP, FP, FN


def compute_f1(TP: int, FP: int, FN: int) -> Tuple[float, float, float]:
    if TP == 0:
        return 0.0, 0.0, 0.0
    p = 100 * TP / (TP + FP)
    r = 100 * TP / (TP + FN)
    f = 100 * 2 * TP / (2 * TP + FN + FP)
    return p, r, f


def filter_informative(labels: Sequence[str], ontology: dict) -> List[str]:
    """Keep act-slot-value labels of informable slots with more than one
    value (and slot "this"); keep every shorter label."""
    out = []
    for lbl in labels:
        tup = lbl.split("-")
        if len(tup) == 3:
            _, slot, _ = tup
            if slot == "this" or (
                    slot in ontology["informable"]
                    and len(ontology["informable"][slot]) > 1):
                out.append(lbl)
        else:
            out.append(lbl)
    return out


def multihot_to_labels(pred: np.ndarray, idx2label: Dict[int, str]
                       ) -> List[List[str]]:
    """(b, n_bottom) bool -> per-row label-string lists."""
    return [[idx2label[int(j)] for j in np.nonzero(row)[0]] for row in pred]


def host_eval_metrics(pred_multihot: np.ndarray,
                      raw_golds: Sequence[Sequence[str]],
                      idx2label: Dict[int, str],
                      ontology: Optional[dict] = None):
    """-> ((p, r, f), acc, pred_strings, gold_strings_after_filter)."""
    preds = multihot_to_labels(pred_multihot, idx2label)
    TP = FP = FN = 0
    corr = tot = 0
    golds_out: List[List[str]] = []
    for pred, gold in zip(preds, raw_golds):
        gold = list(gold)
        if ontology is not None:
            pred = filter_informative(pred, ontology)
            gold = filter_informative(gold, ontology)
        TP, FP, FN = update_f1(pred, gold, TP, FP, FN)
        tot += 1
        corr += set(pred) == set(gold)
        golds_out.append(gold)
    acc = (corr / tot * 100) if tot else 0.0
    return compute_f1(TP, FP, FN), acc, preds, golds_out
