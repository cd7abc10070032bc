"""Raw split container and the multi-hot label encoding -- the port's
copy of the part of ``nbest_asr_tpu/data/dataset.py`` it uses
(``RawSplit``, ``labels_to_multihot``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from .. import constants as C


@dataclass
class RawSplit:
    asr_seqs: List[List[str]]
    trans_seqs: List[List[str]]
    labels: List[List[str]]

    def __len__(self) -> int:
        return len(self.asr_seqs)

    def select(self, idx: Sequence[int]) -> "RawSplit":
        return RawSplit(
            [self.asr_seqs[i] for i in idx],
            [self.trans_seqs[i] for i in idx],
            [self.labels[i] for i in idx],
        )


def labels_to_multihot(labels: Sequence[Sequence[str]], label2idx: dict,
                       n_labels: int) -> np.ndarray:
    """Label-string lists -> multi-hot matrix (b, n_labels); OOV labels map
    to UNK (parity: collate_fn `tod_asr_util.py:118-127`)."""
    out = np.zeros((len(labels), n_labels), dtype=np.float32)
    for i, lbls in enumerate(labels):
        for l in lbls:
            out[i, label2idx.get(l, C.UNK)] = 1.0
    return out
