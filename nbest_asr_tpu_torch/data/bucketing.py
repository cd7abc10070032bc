"""Length-bucket assignment (pure host logic) -- the port's copy of
``nbest_asr_tpu/data/bucketing.py``.

Bucketing groups rows into per-length fixed shapes — one XLA compile per
bucket instead of padding every row to the split max (SURVEY.md §3.1's
static-shape mandate).  The assignment must be identical wherever it is
computed: the single-controller Trainer buckets the device-resident split
(`train/loop.py`), while every process of a multi-host deployment
recomputes the same assignment from the global row-length metadata
(`parallel/process_data.py`) so all processes agree on per-bucket step
counts without exchanging data.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def row_lengths(data: Dict[str, np.ndarray]) -> np.ndarray:
    """Per-row real length: max over the ASR and transcript streams (a row
    lives in the smallest bucket that fits BOTH of its sequences)."""
    return np.maximum(data["attn_mask"].sum(axis=1),
                      data["trans_attn_mask"].sum(axis=1)).astype(np.int32)


def bucket_assignment(row_len: np.ndarray, bucket_lens: List[int],
                      max_len: int) -> List[Tuple[int, np.ndarray]]:
    """Assign each row to the smallest bucket that fits it.

    Returns ``[(bucket_len, row_ids), ...]`` (empty buckets dropped).  The
    last bucket catches everything longer and is widened to its longest
    row (rounded up to a multiple of 8, capped at ``max_len``) — rows are
    NEVER truncated, whatever ladder the user passes.
    """
    bucket_lens = sorted(bucket_lens)
    out: List[Tuple[int, np.ndarray]] = []
    assigned = np.zeros(row_len.shape[0], dtype=bool)
    for i, blen in enumerate(bucket_lens):
        blen = min(int(blen), max_len)
        if i == len(bucket_lens) - 1:
            sel = ~assigned
            if sel.any():
                longest = int(row_len[sel].max())
                if longest > blen:  # widen, never truncate
                    blen = min(-(-longest // 8) * 8, max_len)
        else:
            sel = (~assigned) & (row_len <= blen)
        assigned |= sel
        rows = np.nonzero(sel)[0]
        if rows.size == 0:
            continue
        out.append((blen, rows))
    return out


def slice_rows(data: Dict[str, np.ndarray], rows: np.ndarray,
               blen: int) -> Dict[str, np.ndarray]:
    """Select ``rows`` of each stream and truncate 2-D token streams to the
    bucket length (labels keep their full width)."""
    sub = {}
    for k, v in data.items():
        v_rows = v[rows]
        if v.ndim == 2 and k != "labels":
            v_rows = v_rows[:, :blen]
        sub[k] = np.ascontiguousarray(v_rows)
    return sub
