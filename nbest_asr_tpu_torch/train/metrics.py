"""Host-side metric helpers -- the part of
``nbest_asr_tpu/train/metrics.py`` the serving path uses.  The F1
counters and the string-level eval metrics land with the trainer."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def multihot_to_labels(pred: np.ndarray, idx2label: Dict[int, str]
                       ) -> List[List[str]]:
    """(b, n_bottom) bool -> per-row label-string lists."""
    return [[idx2label[int(j)] for j in np.nonzero(row)[0]] for row in pred]
