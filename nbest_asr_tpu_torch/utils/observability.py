"""Per-epoch observability: prediction CSVs and per-label classification
reports -- a copy of ``nbest_asr_tpu/utils/observability.py``
(``EpochInfo``, ``classification_report``, ``observability_lens``,
:19-95) without pandas, scikit-learn or tabulate, which the card's machine
does not have.

Parity: `utils/dataset/tod_asr_util.py:150-241`.  Runs on the host at
epoch boundaries only; the hierarchy-aware skip rule (predicted labels
outside the gold universe are scored only against gold-universe labels,
ref :176-178) is kept.  The CSV comes out byte for byte as the JAX
package's ``DataFrame.to_csv`` writes it (the ``csv`` module with the
same dialect; lists as ``str(list)``, booleans as ``True``/``False``,
floats by ``repr``, NaN as an empty field); the report's per-label binary
precision / recall / F1 / support are scikit-learn's
``precision_recall_fscore_support(average="binary", zero_division=0)``
in plain Python, in tabulate's "simple" table.
"""

from __future__ import annotations

import csv
import math
import os
from dataclasses import dataclass
from typing import List, Sequence


@dataclass
class EpochInfo:
    raw_inputs: List[str]
    pred_classes: List[List[str]]
    golds: List[List[str]]
    matches: List[bool]
    mean_loss: float
    precision: float
    recall: float
    f1: float
    acc: float


def _div(num: float, den: float) -> float:
    return num / den if den else 0.0


def _binary_prf(y_true: Sequence[int], y_pred: Sequence[int]):
    """scikit-learn's binary P, R, F1 of label 1 with zero_division=0:
    F1 = 2 tp / (true + predicted)."""
    tp = sum(1 for t, p in zip(y_true, y_pred) if t and p)
    n_true, n_pred = sum(y_true), sum(y_pred)
    return (_div(tp, n_pred), _div(tp, n_true),
            _div(2.0 * tp, float(n_true) + float(n_pred)))


def _afterpoint(s: str) -> int:
    """Digits after the decimal point of a formatted number, -1 for an
    integer (tabulate's decimal alignment)."""
    if "." not in s and "e" not in s.lower():
        return -1
    pos = s.rfind(".")
    pos = s.lower().rfind("e") if pos < 0 else pos
    return len(s) - pos - 1


def _simple_table(rows: List[list], headers: List[str]) -> str:
    """tabulate(rows, headers) in its default "simple" format for columns
    of strings (left-aligned) or numbers (floats as "g", decimal-aligned
    to the right)."""
    n = len(headers)
    cols = [[r[j] for r in rows] for j in range(n)]
    numeric = [bool(c) and all(isinstance(v, (int, float)) for v in c)
               for c in cols]
    widths = []
    cells = []
    for h, c, num in zip(headers, cols, numeric):
        minw = len(h) + 2
        if num:
            anyfloat = any(isinstance(v, float) for v in c)
            s = [format(float(v), "g") if anyfloat else str(v) for v in c]
            dec = [_afterpoint(x) for x in s]
            most = max(dec)
            s = [x + " " * (most - d) for x, d in zip(s, dec)]
        else:
            s = [str(v).strip() for v in c]
        w = max([minw] + [len(x) for x in s])
        cells.append([x.rjust(w) if num else x.ljust(w) for x in s])
        widths.append(w)
    head = [h.rjust(w) if num else h.ljust(w)
            for h, w, num in zip(headers, widths, numeric)]
    lines = ["  ".join(head).rstrip(),
             "  ".join("-" * w for w in widths).rstrip()]
    lines += ["  ".join(r).rstrip() for r in zip(*cells)]
    return "\n".join(lines)


def classification_report(pred_classes: Sequence[Sequence[str]],
                          golds: Sequence[Sequence[str]]) -> str:
    """Per-label binary P/R/F1/support table (ref :150-198)."""
    gold_universe = set()
    for g in golds:
        gold_universe |= set(g)

    y_true = {label: [] for label in gold_universe}
    y_pred = {label: [] for label in gold_universe}

    for pred, gold in zip(pred_classes, golds):
        sp, sg = set(pred), set(gold)
        for label in sg:
            y_true[label].append(1)
            y_pred[label].append(1 if label in sp else 0)
        for label in (sp - sg) & gold_universe:
            y_true[label].append(0)
            y_pred[label].append(1)

    rows = []
    for label in sorted(gold_universe):
        p, r, f = _binary_prf(y_true[label], y_pred[label])
        support = y_true[label].count(1)
        rows.append([label, round(p, 2), round(r, 2), round(f, 2),
                     support])
    return _simple_table(rows, ["label", "precision", "recall", "f1-score",
                                "support"])


def _csv_cell(v):
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def observability_lens(info: EpochInfo, epoch: int, dataset_type: str,
                       output_dir: str, extra_name: str) -> None:
    """Writes epoch_<i>_for_<split>_observe_<name>.csv and the per-label
    classification report (ref :202-223)."""
    header = ["epoch", "dataset", "mean_loss", "precision", "recall", "f1",
              "acc", "raw_inputs", "pred_classes", "gold", "matches"]
    stats = [float(info.mean_loss), float(info.precision),
             float(info.recall), float(info.f1), float(info.acc)]
    with open(os.path.join(
            output_dir,
            f"epoch_{epoch}_for_{dataset_type}_observe_{extra_name}.csv"),
            "w", newline="") as fp:
        w = csv.writer(fp, lineterminator="\n",
                       quoting=csv.QUOTE_MINIMAL)
        w.writerow(header)
        for raw, pred, gold, match in zip(info.raw_inputs,
                                          info.pred_classes, info.golds,
                                          info.matches):
            w.writerow([_csv_cell(v) for v in
                        [epoch, dataset_type, *stats, raw, list(pred),
                         list(gold), bool(match)]])

    report = classification_report(info.pred_classes, info.golds)
    with open(os.path.join(
            output_dir,
            f"classification_report_epoch_{epoch}_for_{dataset_type}.txt"),
            "w") as fp:
        fp.write(report)
