"""Shard reading, the coverage sampler, the raw split container and the
multi-hot label encoding -- the port's copy of
``nbest_asr_tpu/data/dataset.py`` (``RawSplit``, ``read_sep_data`` :43,
``stratified_coverage_sample`` :57, ``labels_to_multihot``,
``train_valid_test_paths`` :105).

Parity targets:
- `utils/dataset/tod_asr_util.py:43-71` (`read_wcn_data`): parse the
  3-field ``\\t<=>\\t`` lines into (asr words, transcript words, labels).
- `utils/dataset/tod_asr_util.py:12-39` (`_get_stratified_sampled_data`):
  label-stratified coverage sampling -- keep the first exemplar of every
  unique label-set, then fill to ``coverage * N`` with a seed-42 pandas
  sample of the remainder.  Train-only (`n_best_asr_bert.py:524-526`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

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


def read_sep_data(path: str, coverage: Optional[float] = None) -> RawSplit:
    asr_seqs, trans_seqs, labels = [], [], []
    with open(path) as fp:
        for line in fp:
            asr, trans, lbl = line.strip("\n\r").split(C.FIELD_SEP)
            asr_seqs.append(asr.strip().split(" "))
            trans_seqs.append(trans.strip().split(" "))
            labels.append(lbl.strip().split(C.LABEL_SEP) if lbl else [])
    split = RawSplit(asr_seqs, trans_seqs, labels)
    if coverage:
        split = stratified_coverage_sample(split, coverage)
    return split


def stratified_coverage_sample(split: RawSplit, coverage: float) -> RawSplit:
    """Label-stratified subsample at the given coverage fraction.

    The reference's semantics (`tod_asr_util.py:12-39`): one first-seen
    exemplar per unique label tuple is always kept; the remaining rows are
    sampled without replacement to reach ``round(|coverage*N -
    n_unique|)`` extra rows, in the order pandas' ``rest.sample(n,
    random_state=42)`` picks them -- which is
    ``RandomState(42).choice(len(rest), n, replace=False)`` and a take, so
    numpy alone gives the same rows.
    """
    n = len(split)
    label_tuples = [tuple(l) for l in split.labels]

    seen = set()
    unique_idx: List[int] = []
    for i, t in enumerate(label_tuples):
        if t not in seen:
            seen.add(t)
            unique_idx.append(i)
    unique_set = set(unique_idx)
    rest_idx = [i for i in range(n) if i not in unique_set]

    rem_count = int(np.round(abs(float(coverage) * n - len(unique_idx))))
    rem_count = min(rem_count, len(rest_idx))

    pick = np.random.RandomState(42).choice(len(rest_idx), size=rem_count,
                                            replace=False)
    sampled = [rest_idx[int(j)] for j in pick]
    return split.select(unique_idx + sampled)


def labels_to_multihot(labels: Sequence[Sequence[str]], label2idx: dict,
                       n_labels: int) -> np.ndarray:
    """Label-string lists -> multi-hot matrix (b, n_labels); OOV labels map
    to UNK (parity: collate_fn `tod_asr_util.py:118-127`)."""
    out = np.zeros((len(labels), n_labels), dtype=np.float32)
    for i, lbls in enumerate(labels):
        for l in lbls:
            out[i, label2idx.get(l, C.UNK)] = 1.0
    return out


def train_valid_test_paths(dataroot: str, train_file: str = "train",
                           valid_file: str = "valid",
                           test_file: str = "test") -> Tuple[str, str, str]:
    return (os.path.join(dataroot, train_file),
            os.path.join(dataroot, valid_file),
            os.path.join(dataroot, test_file))
