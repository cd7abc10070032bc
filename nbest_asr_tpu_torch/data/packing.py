"""Example packing: several short utterances share one fixed-shape row --
the port's copy of ``nbest_asr_tpu/data/packing.py``.

DSTC2 is mostly short rows, and the short buckets run the lowest MFU of
the training step (PERFORMANCE.md per-bucket table: 39% at 128x64 vs 45%
at 32x256 on v5e) while per-bucket padding wastes tokens on top.  The
reference pays this in the extreme — it pads every batch to batch-max and
runs 2 full encoder passes over the padding (`utils/bert_xlnet_inputs.py:
91-97`).  Packing concatenates utterances into one `capacity`-token row
so the whole epoch runs at the long-sequence MFU with ~full token
occupancy, while staying EXACTLY the per-utterance math:

- block-diagonal attention via the SEGMENT mask (`ops/attention.py`):
  the (b, s) mask carries 0 = pad / j >= 1 = packed segment j, and every
  attention path (XLA, flash, fused megakernels, int8) lets a query
  attend exactly the keys sharing its mask value,
- per-segment position ids (each utterance sees positions 0..L-1, as
  unpacked),
- per-segment [CLS] gathers (`models/model.py:take_cls`) so the head,
  losses and metrics see one row per UTTERANCE, zeroed for empty
  segment slots by the segment mask.

`tests/test_packing.py` pins bit-equality of the packed vs unpacked
deterministic forward per utterance.

Packing is a training-throughput feature: eval splits stay unpacked (the
per-utterance dump/metric path is exact and cheap there).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _lengths(mask: np.ndarray) -> np.ndarray:
    return mask.astype(bool).sum(axis=1).astype(np.int64)


def plan_bins(asr_len: np.ndarray, trans_len: np.ndarray, capacity: int,
              max_segs: int) -> List[List[int]]:
    """First-fit-decreasing over BOTH streams' budgets: a group of rows
    fits one bin iff the sum of its ASR lengths and the sum of its
    transcript lengths each fit ``capacity`` and the group has at most
    ``max_segs`` rows.  Returns the bins as lists of original row ids
    (every row appears exactly once; rows longer than capacity get a
    singleton bin — shapes stay static because the caller sizes capacity
    to the split max)."""
    order = np.argsort(-(np.maximum(asr_len, trans_len)), kind="stable")
    bins: List[List[int]] = []
    space_a: List[int] = []   # remaining ASR budget per bin
    space_t: List[int] = []
    for r in order:
        la, lt = int(asr_len[r]), int(trans_len[r])
        placed = False
        for i in range(len(bins)):
            if (len(bins[i]) < max_segs and space_a[i] >= la
                    and space_t[i] >= lt):
                bins[i].append(int(r))
                space_a[i] -= la
                space_t[i] -= lt
                placed = True
                break
        if not placed:
            bins.append([int(r)])
            space_a.append(max(capacity - la, 0))
            space_t.append(max(capacity - lt, 0))
    return bins


def _infer_pad_id(ids: np.ndarray, mask: np.ndarray) -> int:
    pad_positions = mask.astype(bool) == False  # noqa: E712
    if pad_positions.any():
        return int(ids[pad_positions].flat[0])
    return 0


def _pack_stream(ids: np.ndarray, mask: np.ndarray, segs: np.ndarray,
                 bins: List[List[int]], capacity: int, max_segs: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                            np.ndarray, np.ndarray]:
    """One token stream -> (ids, seg_mask_values, token_type, position,
    cls_pos) packed arrays."""
    lens = _lengths(mask)
    pad_id = _infer_pad_id(ids, mask)
    m = len(bins)
    out_ids = np.full((m, capacity), pad_id, dtype=np.int32)
    out_mask = np.zeros((m, capacity), dtype=np.float32)
    out_tt = np.zeros((m, capacity), dtype=np.int32)
    out_pos = np.zeros((m, capacity), dtype=np.int32)
    cls_pos = np.zeros((m, max_segs), dtype=np.int32)
    for i, rows in enumerate(bins):
        off = 0
        for j, r in enumerate(rows):
            L = int(lens[r])
            out_ids[i, off:off + L] = ids[r, :L]
            out_mask[i, off:off + L] = float(j + 1)
            out_tt[i, off:off + L] = segs[r, :L]
            out_pos[i, off:off + L] = np.arange(L, dtype=np.int32)
            cls_pos[i, j] = off
            off += L
    return out_ids, out_mask, out_tt, out_pos, cls_pos


def pack_train_data(data: Dict[str, np.ndarray], capacity: int,
                    max_segs: int) -> Tuple[Dict[str, np.ndarray],
                                            List[List[int]]]:
    """Host train dict (`train/loop._host_data` layout) -> packed host
    dict + the bin plan (original row ids per packed row).

    Output keys: the six token streams with SEGMENT-valued attn masks
    plus ``position_ids`` / ``trans_position_ids``, the per-segment
    ``cls_pos`` / ``trans_cls_pos`` (b, max_segs), ``labels``
    (b, max_segs, n_bottom) and ``seg_mask`` (b, max_segs)."""
    asr_len = _lengths(data["attn_mask"])
    trans_len = _lengths(data["trans_attn_mask"])
    capacity = int(capacity)
    longest = int(max(asr_len.max(initial=0), trans_len.max(initial=0)))
    # never truncate: a capacity below the longest utterance widens
    # (rounded to the 8-sublane tile), mirroring data/bucketing.py
    capacity = max(capacity, -(-longest // 8) * 8)
    bins = plan_bins(asr_len, trans_len, capacity, max_segs)

    ids, mask, tt, pos, cls = _pack_stream(
        data["input_ids"], data["attn_mask"], data["segment_ids"],
        bins, capacity, max_segs)
    tids, tmask, ttt, tpos, tcls = _pack_stream(
        data["trans_input_ids"], data["trans_attn_mask"],
        data["trans_segment_ids"], bins, capacity, max_segs)

    n_bottom = data["labels"].shape[1]
    m = len(bins)
    labels = np.zeros((m, max_segs, n_bottom), dtype=data["labels"].dtype)
    seg_mask = np.zeros((m, max_segs), dtype=np.float32)
    for i, rows in enumerate(bins):
        for j, r in enumerate(rows):
            labels[i, j] = data["labels"][r]
            seg_mask[i, j] = 1.0

    packed = {
        "input_ids": ids, "attn_mask": mask, "segment_ids": tt,
        "position_ids": pos, "cls_pos": cls,
        "trans_input_ids": tids, "trans_attn_mask": tmask,
        "trans_segment_ids": ttt, "trans_position_ids": tpos,
        "trans_cls_pos": tcls,
        "labels": labels, "seg_mask": seg_mask,
    }
    return packed, bins
