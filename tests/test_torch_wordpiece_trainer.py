"""The port's WordPiece trainer (``data/wordpiece_trainer.py``) against HF
``tokenizers``' ``WordPieceTrainer`` as the JAX package's
``tools/pretrain_mlm.py:train_wordpiece_vocab`` configures it (BERT's
normalizer with lower-casing, BERT's pre-tokenizer, ``##``), on the CPU.

HF's trainer breaks tied merges by ids that follow a hash map's order, so
its vocabulary is compared only on a corpus without ties: chains of word
prefixes over a few letters, each word repeated a distinct number of
times, seeded (seed 33: every merge to the end is untied).  HF is trained
three times there and must agree with itself before the port is compared
with it.  On a corpus with ties the port must be deterministic, and every
merge must take a pair of the largest count, recounted from scratch.
Tolerance: none (token sets and orders are compared exactly)."""

import random

import pytest

from nbest_asr_tpu_torch.data.wordpiece_trainer import (PREFIX, count_words,
                                                        train_wordpiece)
from nbest_asr_tpu_torch.tools.pretrain_mlm import (SPECIAL_TOKENS,
                                                    train_wordpiece_vocab)


def _tie_free_corpus(seed: int = 33):
    """Four stems of 5-7 letters from a-j; every prefix of two letters or
    more is a word, repeated 1-399 times (distinct counts)."""
    rng = random.Random(seed)
    words = []
    for _ in range(4):
        stem = "".join(rng.choice("abcdefghij")
                       for _ in range(rng.randint(5, 7)))
        words += [stem[:k] for k in range(2, len(stem) + 1)]
    words = list(dict.fromkeys(words))
    counts = rng.sample(range(1, 400), len(words))
    return [" ".join([w] * k) for w, k in zip(words, counts)]


def _tied_corpus(seed: int = 0):
    """400 lines of common DSTC2 words (ties everywhere), with an accent
    and an apostrophe for the normalizer and the pre-tokenizer."""
    rng = random.Random(seed)
    words = ["restaurant", "cheap", "expensive", "north", "south",
             "chinese", "indian", "food", "phone", "number", "address",
             "thank", "you", "goodbye", "what", "is", "the", "area",
             "moderate", "price", "range", "Café", "don't"]
    return [" ".join(rng.choice(words) for _ in range(rng.randint(3, 12)))
            for _ in range(400)]


def _hf_vocab(lines, vocab_size):
    """JAX's ``train_wordpiece_vocab`` trainer: the vocab in id order."""
    from tokenizers import (Tokenizer, models, normalizers, pre_tokenizers,
                            trainers)

    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.train_from_iterator(lines, trainers.WordPieceTrainer(
        vocab_size=vocab_size, special_tokens=SPECIAL_TOKENS,
        continuing_subword_prefix="##"))
    vocab = tok.get_vocab()
    inv = [None] * len(vocab)
    for t, i in vocab.items():
        inv[i] = t
    return inv


def _recount(lines, merges):
    """Replay ``merges`` on the corpus's words, recounting every pair
    before each -> [(merged pair's count, the largest count, the pairs
    that have it)]."""
    counts = count_words(lines)
    words = [[c if i == 0 else PREFIX + c for i, c in enumerate(w)]
             for w in counts]
    out = []
    for a, b, _ in merges:
        pairs = {}
        for w, n in zip(words, counts.values()):
            for p in zip(w, w[1:]):
                pairs[p] = pairs.get(p, 0) + n
        top = max(pairs.values())
        out.append((pairs.get((a, b), 0), top,
                    [p for p, v in pairs.items() if v == top]))
        new = a + (b[len(PREFIX):] if b.startswith(PREFIX) else b)
        for w in words:
            i = 0
            while i < len(w) - 1:
                if w[i] == a and w[i + 1] == b:
                    w[i:i + 2] = [new]
                i += 1
    return out


@pytest.mark.parametrize("spare", [10, 0, None],
                         ids=["cut", "exact", "exhausted"])
def test_trainer_matches_hf_on_a_tie_free_corpus(spare):
    """The same token set as HF's, the specials then the alphabet in HF's
    order; the run stopped 10 merges early, at the vocabulary the merges
    exhaust, and with room to spare."""
    lines = _tie_free_corpus()
    full, merges = train_wordpiece(lines, 10 ** 6, SPECIAL_TOKENS)
    assert all(n == top and len(tied) == 1
               for n, top, tied in _recount(lines, merges))
    assert len(merges) >= 20
    size = 10 ** 4 if spare is None else len(full) - spare
    hf = [_hf_vocab(lines, size) for _ in range(3)]
    assert sorted(hf[1]) == sorted(hf[0]) == sorted(hf[2])
    got, _ = train_wordpiece(lines, size, SPECIAL_TOKENS)
    assert len(got) == len(hf[0]) == min(size, len(full))
    assert sorted(got) == sorted(hf[0])
    n_alpha = len({c for w in count_words(lines) for c in w})
    head = len(SPECIAL_TOKENS) + n_alpha
    assert got[:head] == hf[0][:head]
    assert got[:len(SPECIAL_TOKENS)] == SPECIAL_TOKENS
    assert any(t.startswith(PREFIX) and len(t) > 3 for t in got)


def test_trainer_is_deterministic_and_greedy_on_a_tied_corpus():
    """Two runs give one vocabulary; ``##`` rows in first-seen order; every
    merge takes a pair of the largest count, and of the tied pairs the
    one of the smallest ids."""
    lines = _tied_corpus()
    a, merges = train_wordpiece(lines, 120, SPECIAL_TOKENS)
    b, merges_b = train_wordpiece(lines, 120, SPECIAL_TOKENS)
    assert a == b and merges == merges_b and len(a) == 120
    replay = _recount(lines, merges)
    assert all(n == top for n, top, _ in replay)
    assert sum(len(tied) > 1 for _, _, tied in replay) > 10
    ids = {t: i for i, t in enumerate(a)}
    for (x, y, _), (_, _, tied) in zip(merges, replay):
        assert (ids[x], ids[y]) == min((ids[p], ids[q]) for p, q in tied)
    seen = []
    for w in count_words(lines):
        for c in w[1:]:
            if PREFIX + c not in seen:
                seen.append(PREFIX + c)
    assert [t for t in a if t.startswith(PREFIX) and len(t) == 3] == seen
    assert count_words(["Café don't"]) == {"cafe": 1, "don": 1, "'": 1,
                                           "t": 1}


def test_train_wordpiece_vocab_writes_jax_files(tmp_path):
    """The three tokenizer files of JAX's tool, the vocab padded with
    ``[unusedN]`` to a multiple of 128, and read back by the port's
    ``WordPieceTokenizer`` with the specials' ids in place."""
    import json

    from nbest_asr_tpu_torch.data.tokenizer import WordPieceTokenizer

    lines = _tied_corpus()
    path = train_wordpiece_vocab(lines, str(tmp_path), 150)
    with open(path) as fp:
        vocab = fp.read().splitlines()
    trained, _ = train_wordpiece(lines, 150, SPECIAL_TOKENS)
    n = len(trained)
    assert 128 < n <= 150 and len(vocab) == 256
    assert vocab[:n] == trained
    assert vocab[n:] == [f"[unused{i}]" for i in range(256 - n)]
    with open(tmp_path / "tokenizer_config.json") as fp:
        assert json.load(fp) == {"tokenizer_class": "BertTokenizer",
                                 "do_lower_case": True,
                                 "model_max_length": 512}
    with open(tmp_path / "special_tokens_map.json") as fp:
        assert json.load(fp)["additional_special_tokens"] == ["[SYS]",
                                                               "[USR]"]
    tok = WordPieceTokenizer(str(tmp_path))
    assert tok.vocab_size == len(tok) == 256
    assert tok.convert_tokens_to_ids(SPECIAL_TOKENS) == list(range(7))
    assert tok.tokenize("[SYS] Cheap restaurants [USR]")[0] == "[SYS]"
