"""Vocab bundle ("memory") and the dense label-hierarchy arrays -- the
port's copy of ``nbest_asr_tpu/data/vocab.py``.

The reference ships the vocab bundle as a pickled torch dict
(`helpers/process_dstc2_with_SEP.py:406-428`, loaded at
`n_best_asr_bert.py:489-496`).  Here it is a plain-JSON artifact
(`memory.json`) — no pickle — and on load we precompute the *dense* arrays
that the vectorized TPU head/loss/decode need instead of the reference's
ragged `top2bottom_dict` ModuleDict loops
(`models/modules/hierarchical_classifier.py:18-25, 44-58`):

- ``bottom2top``       (n_bottom,)           top-group index of every bottom label
- ``membership``       (n_top, n_bottom)     {0,1} group-membership matrix
- ``is_multi_top``     (n_top,)              groups with >=2 bottoms
- ``group_last_bottom``(n_top,)              largest bottom idx per group —
  by construction the synthetic ``<top>-NONE`` label when the group has one
  (NONE is injected in a second pass so it always sorts last —
  `process_dstc2_with_SEP.py:315-345`); the reference's decode/CE "empty ->
  last column" convention (`utils/STC_util.py:47-49`) depends on this.
- ``is_none_bottom``   (n_bottom,)           labels ending in ``NONE``
- ``singleton_onehot`` (n_bottom,)           1.0 where the bottom label is the
  sole member of its group (decode emits it directly,
  `n_best_asr_bert.py:205-206`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass(frozen=True)
class HierarchyArrays:
    """Dense numpy views of the label hierarchy (see module docstring)."""

    n_top: int
    n_bottom: int
    bottom2top: np.ndarray        # (n_bottom,) int32
    membership: np.ndarray        # (n_top, n_bottom) float32 {0,1}
    is_multi_top: np.ndarray      # (n_top,) bool
    group_last_bottom: np.ndarray  # (n_top,) int32
    is_none_bottom: np.ndarray    # (n_bottom,) bool
    singleton_onehot: np.ndarray  # (n_bottom,) float32

    @property
    def bottom2top_mat(self) -> np.ndarray:
        """(n_bottom, n_top) 0/1 matrix; parity with
        `utils/STC_util.py:10-26` (`reverse_top2bottom`)."""
        return self.membership.T.copy()


@dataclass
class Memory:
    """The vocab bundle.  Field-for-field parity with the reference memory
    dict (`process_dstc2_with_SEP.py:406-425`), JSON-serialized."""

    word2idx: Dict[str, int]
    label2idx: Dict[str, int]
    toplabel2idx: Dict[str, int]
    top2bottom: Dict[int, List[int]]
    sysact2idx: Dict[str, int]
    act2idx: Dict[str, int]
    slot2idx: Dict[str, int]
    value2idx: Dict[str, int]
    single_acts: List[str] = field(default_factory=list)
    double_acts: List[str] = field(default_factory=list)
    triple_acts: List[str] = field(default_factory=list)

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        self.idx2word = {v: k for k, v in self.word2idx.items()}
        self.idx2label = {v: k for k, v in self.label2idx.items()}
        self.idx2toplabel = {v: k for k, v in self.toplabel2idx.items()}
        self._arrays = None

    @property
    def n_bottom(self) -> int:
        return len(self.label2idx)

    @property
    def n_top(self) -> int:
        return len(self.toplabel2idx)

    def arrays(self) -> HierarchyArrays:
        if self._arrays is None:
            self._arrays = _build_arrays(self)
        return self._arrays

    # ------------------------------------------------------------------ #
    def to_json(self) -> str:
        payload = {
            "word2idx": self.word2idx,
            "label2idx": self.label2idx,
            "toplabel2idx": self.toplabel2idx,
            # JSON keys must be strings
            "top2bottom": {str(k): v for k, v in self.top2bottom.items()},
            "sysact2idx": self.sysact2idx,
            "act2idx": self.act2idx,
            "slot2idx": self.slot2idx,
            "value2idx": self.value2idx,
            "single_acts": self.single_acts,
            "double_acts": self.double_acts,
            "triple_acts": self.triple_acts,
        }
        return json.dumps(payload, ensure_ascii=False)

    def save(self, path: str) -> None:
        with open(path, "w") as fp:
            fp.write(self.to_json())

    @classmethod
    def from_json(cls, text: str) -> "Memory":
        d = json.loads(text)
        return cls(
            word2idx=d["word2idx"],
            label2idx=d["label2idx"],
            toplabel2idx=d["toplabel2idx"],
            top2bottom={int(k): list(v) for k, v in d["top2bottom"].items()},
            sysact2idx=d["sysact2idx"],
            act2idx=d["act2idx"],
            slot2idx=d["slot2idx"],
            value2idx=d["value2idx"],
            single_acts=d.get("single_acts", []),
            double_acts=d.get("double_acts", []),
            triple_acts=d.get("triple_acts", []),
        )

    @classmethod
    def load(cls, path: str) -> "Memory":
        if path.endswith(".pt"):
            return cls.from_torch_pt(path)
        with open(path) as fp:
            return cls.from_json(fp.read())

    @classmethod
    def from_torch_pt(cls, path: str) -> "Memory":
        """Load a reference-format `memory.pt` (torch-pickled dict,
        `n_best_asr_bert.py:489`).  Requires torch; used for golden tests and
        for migrating existing artifacts."""
        import torch  # local import: torch is optional at runtime

        m = torch.load(path, weights_only=False)
        return cls(
            word2idx=dict(m["word2idx"]),
            label2idx=dict(m["label2idx"]),
            toplabel2idx=dict(m["toplabel2idx"]),
            top2bottom={int(k): sorted(v) for k, v in m["top2bottom_dict"].items()},
            sysact2idx=dict(m["sysact2idx"]),
            act2idx=dict(m["act2idx"]),
            slot2idx=dict(m["slot2idx"]),
            value2idx=dict(m["value2idx"]),
            single_acts=list(m.get("single_acts", [])),
            double_acts=list(m.get("double_acts", [])),
            triple_acts=list(m.get("triple_acts", [])),
        )


def _build_arrays(mem: Memory) -> HierarchyArrays:
    n_top, n_bottom = mem.n_top, mem.n_bottom

    bottom2top = np.full((n_bottom,), -1, dtype=np.int32)
    membership = np.zeros((n_top, n_bottom), dtype=np.float32)
    is_multi = np.zeros((n_top,), dtype=bool)
    last_bottom = np.zeros((n_top,), dtype=np.int32)

    for t, bottoms in mem.top2bottom.items():
        bottoms = sorted(bottoms)
        for b in bottoms:
            if bottom2top[b] != -1:
                # parity with `utils/STC_util.py:17-18`
                raise ValueError("map from bottom to top should be unique")
            bottom2top[b] = t
            membership[t, b] = 1.0
        is_multi[t] = len(bottoms) >= 2
        last_bottom[t] = bottoms[-1]

    if (bottom2top < 0).any():
        missing = np.nonzero(bottom2top < 0)[0].tolist()
        raise ValueError(f"bottom labels with no top group: {missing}")

    is_none = np.array(
        [mem.idx2label[i].endswith("NONE") for i in range(n_bottom)], dtype=bool
    )
    group_sizes = membership.sum(axis=1)
    singleton = np.zeros((n_bottom,), dtype=np.float32)
    for b in range(n_bottom):
        if group_sizes[bottom2top[b]] == 1:
            singleton[b] = 1.0

    return HierarchyArrays(
        n_top=n_top,
        n_bottom=n_bottom,
        bottom2top=bottom2top,
        membership=membership,
        is_multi_top=is_multi,
        group_last_bottom=last_bottom,
        is_none_bottom=is_none,
        singleton_onehot=singleton,
    )
