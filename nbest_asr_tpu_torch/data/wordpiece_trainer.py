"""A WordPiece vocabulary trainer without ``tokenizers``: the algorithm of
HF's ``WordPieceTrainer``, which is its BPE trainer with the
continuing-subword prefix ``##`` (``tokenizers``' ``bpe/trainer.rs``),
on BERT's normalizer (lower case, accents stripped) and pre-tokenizer
(``data/tokenizer.bert_normalize`` / ``bert_words``).

The vocabulary it returns, in id order:

1. the special tokens, as given;
2. the alphabet: every character of the corpus's words, sorted by code
   point;
3. a ``##c`` row for each character ``c`` that occurs past a word's first
   character, in the order the corpus first shows it there (words in
   first-seen order, characters left to right);
4. one token per merge until the vocabulary holds ``vocab_size`` rows or
   no pair with a count of at least 1 is left.  A merge joins the adjacent
   pair of tokens with the highest count, each word's pairs weighted by
   the word's count; the new token is the first piece followed by the
   second without its ``##``, and a merge whose string is already in the
   vocabulary adds no row.

Counts are kept as HF keeps them: a priority queue of (count, pair, the
words to merge in) entries, refreshed lazily when an entry's count is
stale.  When a merge makes a pair that already had an entry, the new
entry lists only the words where the pair just formed -- the trainer's
own behaviour, kept so that its vocabularies are HF's.

**Ties.**  HF's trainer is not deterministic across processes: ``##``
rows and the ids of merged tokens follow a hash map's order, and tied
merges are broken by those ids, so the set of tokens itself can vary
from run to run on a corpus with ties.  This trainer is deterministic:
``##`` rows take their first-seen order (item 3), a tie in count goes to
the smaller pair of ids (compared as (first id, second id), HF's own tie
rule once its ids are fixed), and two entries of one pair at one count
are taken oldest first.  On a corpus without ties its vocabulary equals HF's as a set,
with the specials and the alphabet in HF's order.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from .tokenizer import bert_normalize, bert_words

PREFIX = "##"
Pair = Tuple[int, int]


def count_words(lines: Iterable[str]) -> Dict[str, int]:
    """Word -> count over the normalized (lower-cased, accents stripped),
    pre-tokenized lines, in first-seen order."""
    counts: Dict[str, int] = {}
    for line in lines:
        for w in bert_words(bert_normalize(line, True, True)):
            counts[w] = counts.get(w, 0) + 1
    return counts


def _merge_word(word: List[int], a: int, b: int, new: int
                ) -> List[Tuple[Pair, int]]:
    """Merge every (a, b) in ``word`` left to right, in place -> the
    pair-count changes (``Word::merge``)."""
    changes = []
    i = 0
    while i < len(word):
        if word[i] == a and i + 1 < len(word) and word[i + 1] == b:
            if i > 0:
                changes.append(((word[i - 1], a), -1))
                changes.append(((word[i - 1], new), 1))
            word[i:i + 2] = [new]
            if i < len(word) - 1:
                changes.append(((b, word[i + 1]), -1))
                changes.append(((new, word[i + 1]), 1))
        i += 1
    return changes


def train_wordpiece(lines: Iterable[str], vocab_size: int,
                    special_tokens: Sequence[str] = ()
                    ) -> Tuple[List[str], List[Tuple[str, str, int]]]:
    """-> (the trained vocabulary in id order (module docstring), the
    merges in order as (first token, second token, count))."""
    counts = count_words(lines)
    id_to_word: List[str] = []
    word_to_id: Dict[str, int] = {}

    def add(tok: str) -> int:
        if tok not in word_to_id:
            word_to_id[tok] = len(id_to_word)
            id_to_word.append(tok)
        return word_to_id[tok]

    for tok in special_tokens:
        add(tok)
    for ch in sorted({c for w in counts for c in w}, key=ord):
        add(ch)
    words: List[List[int]] = []
    weights: List[int] = []
    for w, n in counts.items():
        words.append([add(c if i == 0 else PREFIX + c)
                      for i, c in enumerate(w)])
        weights.append(n)

    pair_counts: Dict[Pair, int] = {}
    where: Dict[Pair, Set[int]] = {}
    for iw, word in enumerate(words):
        for pair in zip(word, word[1:]):
            pair_counts[pair] = pair_counts.get(pair, 0) + weights[iw]
            where.setdefault(pair, set()).add(iw)

    queue: list = []
    seq = 0

    def push(pair: Pair, count: int, pos: Set[int]) -> None:
        nonlocal seq
        heapq.heappush(queue, (-count, pair, seq, pos))
        seq += 1

    def flush() -> None:
        for pair in sorted(where):
            if pair_counts[pair] > 0:
                push(pair, pair_counts[pair], where[pair])
        where.clear()

    flush()
    merges: List[Tuple[str, str, int]] = []
    while len(word_to_id) < vocab_size and queue:
        neg, pair, _, pos = heapq.heappop(queue)
        if -neg != pair_counts[pair]:
            push(pair, pair_counts[pair], pos)
            continue
        if -neg < 1:
            break
        a, b = pair
        part_b = id_to_word[b]
        if part_b.startswith(PREFIX):
            part_b = part_b[len(PREFIX):]
        new = add(id_to_word[a] + part_b)
        merges.append((id_to_word[a], id_to_word[b], -neg))
        for iw in sorted(pos):
            for p, change in _merge_word(words[iw], a, b, new):
                pair_counts[p] = pair_counts.get(p, 0) + change * weights[iw]
                if change > 0:
                    where.setdefault(p, set()).add(iw)
        flush()
    return id_to_word, merges
