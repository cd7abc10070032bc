"""Offline, vectorized input building: raw word lists -> fixed-shape arrays
-- the port's copy of ``nbest_asr_tpu/data/input_builder.py``.

Reproduces the three input layouts of `utils/bert_xlnet_inputs.py:4-104`
once per dataset (the reference rebuilds them per batch per epoch on the
training hot path, `n_best_asr_bert.py:249-250`):

- TOD-BERT (``tod_pre_trained_model``):
    ``[CLS] [SYS] sys [USR] hyps [SEP]``, segments 0 over [CLS]+[SYS]+sys,
    1 over [USR]+hyps+[SEP]  (ref :30-35, 55-65)
- ``--without_system_act``:
    ``[CLS] hyps [SEP]``, no segment ids  (ref :70-72)
- default:
    ``[CLS] sys [SEP] hyp1 [SEP] hyp2 ... [SEP]``, segments 0 over
    [CLS]+sys, 1 over the rest  (ref :74-85)

XLM-R renders inter-hypothesis ``[SEP]`` as a doubled separator
(ref :37-40).  Deliberate fix vs the reference: we emit a *real* attention
mask from sequence lengths instead of the ``input_ids > 0`` quirk that
breaks XLM-R (pad=1, bos=0 — ref `models/model.py:43`); see SURVEY.md §7.

Output arrays are padded to one static ``max_len`` (rounded up to a
multiple of 8 lanes-friendly sublanes) so every train/eval step compiles
once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import constants as C
from .dataset import RawSplit, labels_to_multihot
from .tokenizer import BaseTokenizer
from .vocab import Memory


@dataclass
class BuiltInputs:
    tokens: List[List[str]]
    segment_ids: Optional[List[List[int]]]   # None when layout has no segs


def build_inputs(raw_seqs: Sequence[Sequence[str]], tokenizer: BaseTokenizer,
                 layout: str = "default") -> BuiltInputs:
    """raw word sequences (``[CLS] [SYS] sys... [USR] user...``) -> token
    lists + segment ids per the selected layout.

    ``layout``: 'default' | 'tod' | 'no_system_act'.
    """
    assert layout in ("default", "tod", "no_system_act")
    sep = tokenizer.sep_token
    inter_hyp_sep = [sep, sep] if tokenizer.double_sep else [sep]

    all_tokens: List[List[str]] = []
    all_segs: List[List[int]] = []

    for seq in raw_seqs:
        usr_idx = list(seq).index(C.USR_MARK)
        seq_a = list(seq[2:usr_idx])       # skip the literal [CLS] [SYS]
        seq_b = list(seq[usr_idx + 1:])

        if layout == "tod":
            seq_a = [C.SYS_MARK] + seq_a
            seq_b = [C.USR_MARK] + seq_b

        tok_a: List[str] = []
        for w in seq_a:
            tok_a += tokenizer.tokenize(w)
        tok_b: List[str] = []
        for w in seq_b:
            if w == C.SEP_MARK:
                tok_b += inter_hyp_sep
            else:
                tok_b += tokenizer.tokenize(w)

        if layout == "tod":
            tok_a = [tokenizer.cls_token] + tok_a
            tok_b = tok_b + [sep]
            all_tokens.append(tok_a + tok_b)
            all_segs.append([0] * len(tok_a) + [1] * len(tok_b))
        elif layout == "no_system_act":
            all_tokens.append([tokenizer.cls_token] + tok_b + [sep])
        else:
            tok_a = [tokenizer.cls_token] + tok_a
            tok_b = inter_hyp_sep + tok_b + [sep]
            all_tokens.append(tok_a + tok_b)
            all_segs.append([0] * len(tok_a) + [1] * len(tok_b))

    return BuiltInputs(all_tokens, all_segs if all_segs else None)


@dataclass
class PackedSplit:
    """Fixed-shape arrays for one dataset split.  Everything the jitted
    train/eval steps consume, plus the raw strings for host-side dumps."""

    input_ids: np.ndarray       # (n, L) int32
    segment_ids: np.ndarray     # (n, L) int32 (zeros when layout has none)
    attn_mask: np.ndarray       # (n, L) float32 real mask
    trans_input_ids: np.ndarray
    trans_segment_ids: np.ndarray
    trans_attn_mask: np.ndarray
    labels: np.ndarray          # (n, n_bottom) float32 multi-hot
    raw_asr: List[List[str]]    # for eval dumps (ref eval_epoch :357-364)
    raw_labels: List[List[str]]  # gold strings (OOV labels preserved)
    max_len: int

    def __len__(self) -> int:
        return self.input_ids.shape[0]


def _pad_to(ids: List[List[int]], segs: Optional[List[List[int]]],
            max_len: int, pad_id: int) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    n = len(ids)
    out_ids = np.full((n, max_len), pad_id, dtype=np.int32)
    out_segs = np.zeros((n, max_len), dtype=np.int32)
    out_mask = np.zeros((n, max_len), dtype=np.float32)
    for i, seq in enumerate(ids):
        L = min(len(seq), max_len)
        out_ids[i, :L] = seq[:L]
        out_mask[i, :L] = 1.0
        if segs is not None:
            out_segs[i, :L] = segs[i][:L]
    return out_ids, out_segs, out_mask


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_split(split: RawSplit, tokenizer: BaseTokenizer, memory: Memory,
               layout: str = "default", max_len: Optional[int] = None,
               len_multiple: int = 8) -> PackedSplit:
    """Tokenize + lay out + pad one split into fixed-shape arrays.

    ``max_len=None`` sizes to the longest sequence in the split (rounded up
    to ``len_multiple`` for TPU-friendly tiling); a fixed cap truncates the
    tail (the reference never truncates — DSTC2 tops out well under 512
    subwords, SURVEY.md §2.2)."""
    asr = build_inputs(split.asr_seqs, tokenizer, layout)
    trans = build_inputs(split.trans_seqs, tokenizer, layout)

    asr_ids = [tokenizer.convert_tokens_to_ids(t) for t in asr.tokens]
    trans_ids = [tokenizer.convert_tokens_to_ids(t) for t in trans.tokens]

    if max_len is None:
        longest = max(
            max((len(s) for s in asr_ids), default=1),
            max((len(s) for s in trans_ids), default=1),
        )
        max_len = round_up(longest, len_multiple)

    pad_id = tokenizer.pad_token_id
    in_ids, in_segs, in_mask = _pad_to(asr_ids, asr.segment_ids,
                                       max_len, pad_id)
    tr_ids, tr_segs, tr_mask = _pad_to(trans_ids, trans.segment_ids,
                                       max_len, pad_id)

    labels = labels_to_multihot(split.labels, memory.label2idx,
                                memory.n_bottom)

    return PackedSplit(
        input_ids=in_ids, segment_ids=in_segs, attn_mask=in_mask,
        trans_input_ids=tr_ids, trans_segment_ids=tr_segs,
        trans_attn_mask=tr_mask, labels=labels,
        raw_asr=[list(s) for s in split.asr_seqs],
        raw_labels=[list(l) for l in split.labels],
        max_len=max_len,
    )
