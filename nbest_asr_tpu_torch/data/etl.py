"""DSTC2 N-best ETL: raw session logs -> processed text shards +
memory.json -- the port's copy of ``nbest_asr_tpu/data/etl.py``
(``SPLIT_MAP`` / ``SPLIT_MAP_DSTC3`` :39-54, ``get_label`` :55,
``split_label`` :71, ``walk_system_acts`` :80, ``TurnRecord`` :101,
``SessionStats`` :113, ``process_session`` :119, ``build_memory`` :168,
``run_etl`` :267), byte for byte in what it writes.

Offline, run-once, pure Python (no accelerator).  Semantics parity with the
reference preprocessor `helpers/process_dstc2_with_SEP.py`:

- label extraction rules (`get_label`, ref :30-49) including the
  request-slot rule (``request`` takes ``slot[1]`` as the label tail);
- line format ``asr \\t<=>\\t transcript \\t<=>\\t lbl1;lbl2`` (ref :245);
- input framing ``[CLS] [SYS] <sys> [USR] hyp1 [SEP] hyp2 ...`` (ref
  :208-227) with empty hypotheses dropped before joining (ref :209);
- turn-drop rule: empty input / empty labels / empty system response
  (ref :240-241);
- vocab building: word vocab by frequency with special tokens first
  (ref :259-280), label + top-label vocabs with the ``<top>-NONE``
  injection for every value-bearing top group (ref :315-341) -- NONE is
  added in a second pass so it always receives the largest index in its
  group, the invariant the decode/CE "empty -> last column" convention
  depends on; groups are sorted+deduped afterwards (ref :343-345);
- system-act token walk with the compound act/slot split map
  (ref `process_sys_acts` :84-170, `helpers/act_slot_split_map.py`);
- act/slot/value vocabs (ref :360-403).

The output memory bundle is JSON (`Memory.save`) rather than a torch pickle.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from .. import constants as C
from .vocab import Memory

# Compound act/slot names that are split into natural words before entering
# the system-act vocab (parity: `helpers/act_slot_split_map.py:1-18`).
SPLIT_MAP: Dict[str, List[str]] = {
    "reqalts": ["request", "alternative"],
    "reqmore": ["request", "more"],
    "addr": ["address"],
    "thankyou": ["thank", "you"],
    "pricerange": ["price", "range"],
}

SPLIT_MAP_DSTC3: Dict[str, List[str]] = {
    **SPLIT_MAP,
    "childrenallowed": ["children", "allowed"],
    "hasinternet": ["has", "internet"],
    "hastv": ["has", "tv"],
}


def get_label(sem: dict) -> str:
    """Semantic dict -> flat label string (ref :30-49)."""
    slots = sem["slots"]
    act = sem["act"]
    assert len(slots) in (0, 1)
    if not slots:
        return act
    slot = slots[0]
    assert len(slot) in (1, 2)
    if len(slot) == 1:
        return f"{act}-{slot[0]}"
    if act == "request":
        return f"{act}-{slot[1]}"
    return f"{act}-{slot[0]}-{slot[1]}"


def split_label(label: str) -> Tuple[str, str | None]:
    """act/act-slot -> (label, None); act-slot-value -> (act-slot, label)
    (ref :52-62)."""
    parts = label.split("-")
    if len(parts) <= 2:
        return label, None
    return "-".join(parts[:2]), label


def walk_system_acts(sys_acts: Sequence[dict],
                     split_map: Dict[str, List[str]] = SPLIT_MAP,
                     ) -> Dict[str, List[str]]:
    """Collect act/slot/value word tokens from a turn's system dialog-acts,
    splitting compound names (vocab side of ref `process_sys_acts` :84-170;
    the tree indices are computed there too but only the vocab side-effects
    are consumed by the active pipeline, ref :198-202)."""
    mem = {"act": [], "slot": [], "value": []}
    for term in sys_acts:
        act = term["act"]
        mem["act"].extend(split_map.get(act, [act]))
        for slot, value in term["slots"]:
            if slot == "slot":
                slot, value = value, None
            mem["slot"].extend(split_map.get(slot, [slot]))
            if value is not None:
                mem["value"].extend(str(value).strip().split())
    return mem


@dataclass
class TurnRecord:
    asr_in: str         # '[CLS] [SYS] <sys> [USR] hyp1 [SEP] hyp2 ...'
    trans_in: str       # same framing around the manual transcript
    labels: List[str]   # flat label strings

    def to_line(self) -> str:
        return C.FIELD_SEP.join(
            [self.asr_in, self.trans_in, C.LABEL_SEP.join(self.labels)]
        ) + "\n"


@dataclass
class SessionStats:
    words: List[str] = field(default_factory=list)
    labels: Set[str] = field(default_factory=set)
    sysact_tokens: List[str] = field(default_factory=list)


def process_session(log_data: dict, label_data: dict,
                    split_map: Dict[str, List[str]] = SPLIT_MAP,
                    augment: bool = False, upsample_count: int = 3,
                    ) -> Tuple[List[TurnRecord], SessionStats]:
    """One DSTC2 session (log.json + label.json) -> turn records + vocab
    stats (ref `read_wcn_data_and_save` :173-256).

    ``augment`` upsamples each turn with ``upsample_count`` extra copies
    whose ASR side is the manual transcript (the reference's dormant
    augmentation, ref :250-253 — its implementation writes 2-field lines
    the active reader cannot parse; here the copies are valid 3-field
    records, trans-as-asr)."""
    assert log_data["session-id"] == label_data["session-id"]
    records: List[TurnRecord] = []
    stats = SessionStats()

    for turn, turn2 in zip(log_data["turns"], label_data["turns"]):
        assert turn["turn-index"] == turn2["turn-index"]

        sa = walk_system_acts(turn["output"]["dialog-acts"], split_map)
        stats.sysact_tokens.extend(sa["act"] + sa["slot"] + sa["value"])

        nbest = [h["asr-hyp"] for h in turn["input"]["batch"]["asr-hyps"]
                 if h["asr-hyp"].rstrip() != ""]
        manual = turn2["transcription"]
        sys_resp = turn["output"]["transcript"]

        in_seq = (f"{C.CLS_MARK} {C.SYS_MARK} {sys_resp} {C.USR_MARK} "
                  + f" {C.SEP_MARK} ".join(nbest))
        trans_seq = (f"{C.CLS_MARK} {C.SYS_MARK} {sys_resp} "
                     f"{C.USR_MARK} {manual}")

        for hyp in nbest:
            stats.words += hyp.split() + sys_resp.split()

        labels = [get_label(s) for s in turn2["semantics"]["json"]]
        stats.labels |= set(labels)

        if (in_seq.rstrip() == "" or not labels
                or sys_resp.rstrip() == ""):
            continue
        records.append(TurnRecord(in_seq, trans_seq, labels))
        if augment:
            for _ in range(upsample_count):
                records.append(TurnRecord(trans_seq, trans_seq, labels))

    return records, stats


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


def run_etl(data_dir: str, out_dir: str,
            split_map: Dict[str, List[str]] = SPLIT_MAP,
            augment: bool = False, upsample_count: int = 3) -> None:
    """Full ETL over the DSTC2 directory layout (ref :431-521): flist files
    under scripts/config/, sessions under ori_data/, shards + memory.json +
    a stats log under <out_dir>/processed_data/raw/.

    ``augment`` applies the transcript-upsample augmentation to the TRAIN
    split only (``upsample_count`` trans-as-asr copies per turn — the
    reference's dormant path, ref :250-253 invoked with augment=False at
    :499); eval splits are never augmented."""
    out = os.path.join(out_dir, "processed_data", "raw")
    os.makedirs(out, exist_ok=True)

    flists = {}
    for mode, name in (("train", "dstc2_train"), ("valid", "dstc2_dev"),
                       ("test", "dstc2_test")):
        scp = os.path.join(data_dir, "scripts", "config", f"{name}.flist")
        with open(scp) as fp:
            flists[mode] = [ln.strip() for ln in fp if ln.strip()]

    train_stats = SessionStats()
    all_words: List[str] = []
    all_labels: Set[str] = set()
    train_label_order: List[str] = []
    seen_train_labels: Set[str] = set()

    for mode in ("train", "valid", "test"):
        with open(os.path.join(out, mode), "w") as fp:
            for rel in flists[mode]:
                base = os.path.join(data_dir, "ori_data", rel)
                with open(os.path.join(base, "log.json")) as f:
                    log_data = json.load(f)
                with open(os.path.join(base, "label.json")) as f:
                    label_data = json.load(f)
                records, stats = process_session(
                    log_data, label_data, split_map,
                    augment=augment and mode == "train",
                    upsample_count=upsample_count)
                for rec in records:
                    fp.write(rec.to_line())
                if mode == "train":
                    train_stats.words += stats.words
                    train_stats.sysact_tokens += stats.sysact_tokens
                    for rec in records:
                        for lbl in rec.labels:
                            if lbl not in seen_train_labels:
                                seen_train_labels.add(lbl)
                                train_label_order.append(lbl)
                    # also count labels of dropped turns, as the reference
                    # unions label_set before the drop filter (ref :236-241)
                    for lbl in stats.labels:
                        if lbl not in seen_train_labels:
                            seen_train_labels.add(lbl)
                            train_label_order.append(lbl)
                all_words += stats.words
                all_labels |= stats.labels

    mem = build_memory(train_stats.words, train_label_order,
                       train_stats.sysact_tokens)
    mem.save(os.path.join(out, "memory.json"))

    with open(os.path.join(out, "log"), "w") as fp:
        fp.write(f"train word vocab size: {len(set(train_stats.words))}\n")
        fp.write(f"all word vocab size: {len(set(all_words))}\n")
        fp.write("out-of-train-vocab size: "
                 f"{len(set(all_words) - set(train_stats.words))}\n")
        fp.write(f"#train labels: {len(seen_train_labels)}\n")
        fp.write(f"#all labels: {len(all_labels)}\n")
        fp.write("out-of-train-label size: "
                 f"{len(all_labels - seen_train_labels)}\n")
