"""Vocab-bundle building -- the port's copy of ``build_memory`` and
``split_label`` from ``nbest_asr_tpu/data/etl.py`` (the DSTC2 log ETL
itself stays in the JAX package: it runs once, offline).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Set, Tuple

from .. import constants as C
from .vocab import Memory


def split_label(label: str) -> Tuple[str, str | None]:
    """act/act-slot -> (label, None); act-slot-value -> (act-slot, label)
    (ref :52-62)."""
    parts = label.split("-")
    if len(parts) <= 2:
        return label, None
    return "-".join(parts[:2]), label


def build_memory(words: Iterable[str], labels: Iterable[str],
                 sysact_tokens: Iterable[str], min_freq: int = 1) -> Memory:
    """Build the vocab bundle (ref `build_vocab_and_save` :259-428).

    Label iteration order matters for index assignment: the reference
    iterates `list(labels)` of a python set; here callers pass an explicit
    ordered sequence (tests pass reference-matching orders; the ETL passes
    first-seen order for determinism)."""
    word2idx = {
        C.PAD_WORD: C.PAD, C.UNK_WORD: C.UNK, C.BOS_WORD: C.BOS,
        C.EOS_WORD: C.EOS, C.CLS_WORD: C.CLS,
    }
    for word, count in Counter(words).most_common():
        if count >= min_freq and word not in word2idx:
            word2idx[word] = len(word2idx)

    label2idx = {C.PAD_WORD: C.PAD, C.UNK_WORD: C.UNK}
    toplabel2idx = {C.PAD_WORD: C.PAD, C.UNK_WORD: C.UNK}
    top2bottom: Dict[int, List[int]] = {C.PAD: [C.PAD], C.UNK: [C.UNK]}

    labels = list(labels)
    for label in labels:
        if label in label2idx:
            continue
        bottom_idx = len(label2idx)
        label2idx[label] = bottom_idx
        top, bottom = split_label(label)
        if top in toplabel2idx:
            if bottom is not None:
                top2bottom[toplabel2idx[top]].append(bottom_idx)
        else:
            top_idx = len(toplabel2idx)
            toplabel2idx[top] = top_idx
            top2bottom[top_idx] = [bottom_idx]

    # Second pass: inject <top>-NONE for every value-bearing top group.
    # Being a second pass guarantees NONE gets the largest index in its
    # group (ref :315-341) — the decode convention depends on it.
    done_tops: Set[str] = set()
    for label in labels:
        top, bottom = split_label(label)
        if bottom is None or top in done_tops:
            continue
        none_label = f"{top}-NONE"
        assert none_label not in label2idx
        none_idx = len(label2idx)
        label2idx[none_label] = none_idx
        top2bottom[toplabel2idx[top]].append(none_idx)
        done_tops.add(top)

    top2bottom = {k: sorted(set(v)) for k, v in top2bottom.items()}

    sysact2idx = {C.PAD_WORD: C.PAD, C.UNK_WORD: C.UNK, C.CLS_WORD: C.CLS}
    for tok in sysact_tokens:
        if tok not in sysact2idx:
            sysact2idx[tok] = len(sysact2idx)

    # act / slot / value vocabs (ref :360-403)
    acts, slots, value_words = [], [], []
    single_acts, double_acts, triple_acts = set(), set(), set()
    for label in labels:
        parts = label.split("-", 2)
        acts.append(parts[0])
        if len(parts) == 1:
            single_acts.add(parts[0])
        elif len(parts) == 2:
            double_acts.add(parts[0])
            slots.append(parts[1])
        else:
            triple_acts.add(parts[0])
            slots.append(parts[1])
            value_words.extend(parts[2].split(" "))

    act2idx = {C.PAD_WORD: C.PAD}
    for a in sorted(set(acts)):
        act2idx.setdefault(a, len(act2idx))
    slot2idx = {C.PAD_WORD: C.PAD}
    for s in sorted(set(slots)):
        slot2idx.setdefault(s, len(slot2idx))
    value2idx = {C.PAD_WORD: C.PAD, C.UNK_WORD: C.UNK,
                 C.BOS_WORD: C.BOS, C.EOS_WORD: C.EOS}
    for v in sorted(set(value_words)):
        value2idx.setdefault(v, len(value2idx))

    return Memory(
        word2idx=word2idx,
        label2idx=label2idx,
        toplabel2idx=toplabel2idx,
        top2bottom=top2bottom,
        sysact2idx=sysact2idx,
        act2idx=act2idx,
        slot2idx=slot2idx,
        value2idx=value2idx,
        single_acts=sorted(single_acts),
        double_acts=sorted(double_acts),
        triple_acts=sorted(triple_acts),
    )
