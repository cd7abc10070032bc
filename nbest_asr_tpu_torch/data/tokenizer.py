"""Tokenizers behind one small interface -- the port's copy of
``nbest_asr_tpu/data/tokenizer.py`` (``HF_NAMES`` :28,
``resolve_checkpoint`` :35, ``BaseTokenizer``, ``WordVocabTokenizer``,
``HFTokenizerAdapter`` :108, ``load_tokenizer`` :131), plus a
``WordPieceTokenizer`` that the JAX package does not have.

- ``WordVocabTokenizer``: whole words over the ETL's word vocab, for
  from-scratch training.
- ``WordPieceTokenizer``: BERT's WordPiece read from a checkpoint
  directory (``vocab.txt``, ``tokenizer_config.json``,
  ``special_tokens_map.json``, ``added_tokens.json``) without
  ``transformers``: the ids ``AutoTokenizer`` (``BertTokenizerFast``)
  gives on the same directory.  ``load_tokenizer`` takes it for every
  BERT-family directory, on every machine.
- ``HFTokenizerAdapter``: a ``transformers`` tokenizer (imported when one
  is built), for RoBERTa's BPE and XLM-R's SentencePiece.
"""

from __future__ import annotations

import json
import os
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Sequence

from .. import constants as C
from .vocab import Memory

HF_NAMES = {
    "bert": "bert-base-uncased",
    "roberta": "roberta-base",
    "xlm-roberta": "xlm-roberta-base",
}
BERT_TOKENIZER_CLASSES = ("BertTokenizer", "BertTokenizerFast")


def resolve_checkpoint(name: str) -> str:
    """``$NBEST_HF_LOCAL/<name>`` when that directory exists, else
    ``name`` (for ``transformers``' own local-cache resolution)."""
    root = os.environ.get("NBEST_HF_LOCAL")
    if root:
        cand = os.path.join(root, name)
        if os.path.isdir(cand):
            return cand
    return name


class BaseTokenizer:
    cls_token: str
    sep_token: str
    pad_token: str
    pad_token_id: int
    vocab_size: int
    # True when '[SEP]' between n-best hypotheses must be rendered as a
    # doubled separator (XLM-R convention, `bert_xlnet_inputs.py:37-40`).
    double_sep: bool = False

    def tokenize(self, word: str) -> List[str]:
        raise NotImplementedError

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        raise NotImplementedError


class WordVocabTokenizer(BaseTokenizer):
    """Whole-word tokenizer over the ETL word vocab.

    ids reuse the memory's word2idx (PAD=0, UNK=1, ..., CLS=4) and append a
    dedicated ``<sep>`` id at the end (same trick as reference
    `utils/util.py:66-70`).
    """

    def __init__(self, memory: Memory, lowercase: bool = True):
        self.vocab: Dict[str, int] = dict(memory.word2idx)
        self.lowercase = lowercase
        self.cls_token = C.CLS_WORD
        self.pad_token = C.PAD_WORD
        self.sep_token = "<sep>"
        # [SYS]/[USR] are special tokens in the TOD-BERT vocab the reference
        # relies on (`bert_xlnet_inputs.py:30-35`); register them so the TOD
        # layout round-trips through the fallback tokenizer as well.
        for special in (self.sep_token, C.SYS_MARK, C.USR_MARK):
            if special not in self.vocab:
                self.vocab[special] = len(self.vocab)
        self.pad_token_id = self.vocab[C.PAD_WORD]
        self.vocab_size = len(self.vocab)

    def tokenize(self, word: str) -> List[str]:
        if not word:
            # empty tokens from doubled spaces in the raw shards vanish,
            # matching HF tokenizers' tokenize('') == [] (the serialized
            # lines do contain double spaces, e.g. "are  restaurants")
            return []
        if word in self.vocab:  # specials & exact hits bypass lowercasing
            return [word]
        if self.lowercase:
            word = word.lower()
        return [word if word in self.vocab else C.UNK_WORD]

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, C.UNK) for t in tokens]


# --------------------------------------------------------------------- #
# BERT WordPiece without transformers
# --------------------------------------------------------------------- #

def _read_json(path: str) -> dict:
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as fp:
        return json.load(fp)


def _content(tok) -> Optional[str]:
    """An added token as its text (tokenizer files give a string or a
    dict with ``content``)."""
    return tok.get("content") if isinstance(tok, dict) else tok


def is_bert_family_dir(path: str) -> bool:
    """A directory whose tokenizer is BERT's WordPiece:
    ``tokenizer_config.json`` names ``BertTokenizer`` or
    ``BertTokenizerFast``, or a ``vocab.txt`` lies beside a ``config.json``
    whose ``model_type`` is ``bert``."""
    if not os.path.isdir(path):
        return False
    tc = _read_json(os.path.join(path, "tokenizer_config.json"))
    if tc.get("tokenizer_class") in BERT_TOKENIZER_CLASSES:
        return True
    return os.path.isfile(os.path.join(path, "vocab.txt")) and _read_json(
        os.path.join(path, "config.json")).get("model_type") == "bert"


def _is_chinese(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 \
            or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_space(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) in ("Zs", "Zl", "Zp")


def bert_normalize(text: str, lower: bool, strip_accents: bool,
                   chinese: bool = True) -> str:
    """BERT's normalizer: control characters dropped, whitespace to
    spaces, spaces around CJK ideographs (``chinese``), accents stripped
    (NFD, Mn marks dropped), then lower case."""
    chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or (
                ch not in "\t\n\r"
                and unicodedata.category(ch).startswith("C")):
            continue
        if _is_space(ch):
            chars.append(" ")
        elif chinese and _is_chinese(cp):
            chars.append(f" {ch} ")
        else:
            chars.append(ch)
    text = "".join(chars)
    if strip_accents:
        text = "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")
    if lower:
        text = text.lower()
    return text


def bert_words(text: str) -> List[str]:
    """BERT's pre-tokenizer: split on whitespace, each punctuation
    character a word of its own."""
    words, cur = [], []
    for ch in text:
        if _is_space(ch) or ch.isspace():
            if cur:
                words.append("".join(cur))
                cur = []
        elif _is_punct(ch):
            if cur:
                words.append("".join(cur))
                cur = []
            words.append(ch)
        else:
            cur.append(ch)
    if cur:
        words.append("".join(cur))
    return words


class WordPieceTokenizer(BaseTokenizer):
    """BERT's tokenizer from a checkpoint directory, as ``BertTokenizerFast``
    runs it:

    1. added tokens (``added_tokens_decoder``, ``added_tokens.json`` and the
       special tokens) split the raw text first, longest match first, and
       pass through whole -- those with ``normalized`` set are matched on
       the normalized text instead;
    2. BERT's normalizer: control characters dropped, whitespace to
       spaces, spaces around CJK ideographs, accents stripped (NFD, Mn
       marks dropped) when ``strip_accents`` is set or, if it is null, when
       ``do_lower_case`` is, then lower case;
    3. split on whitespace, each punctuation character a word of its own;
    4. WordPiece: greedy longest match with the ``##`` prefix; a word with
       no match, or over 100 characters, is ``[UNK]``.

    ``vocab_size`` counts ``vocab.txt`` alone, as ``AutoTokenizer``'s
    does: added tokens' ids lie past it."""

    def __init__(self, path: str, family: Optional[str] = None):
        vocab_path = os.path.join(path, "vocab.txt")
        if not os.path.isfile(vocab_path):
            raise OSError(f"no WordPiece vocab at {vocab_path!r}")
        self.vocab: Dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as fp:
            for i, line in enumerate(fp):
                self.vocab[line.rstrip("\n")] = i
        self.vocab_size = len(self.vocab)
        tc = _read_json(os.path.join(path, "tokenizer_config.json"))
        sm = _read_json(os.path.join(path, "special_tokens_map.json"))
        self.do_lower_case = bool(tc.get("do_lower_case", True))
        strip = tc.get("strip_accents")
        self.strip_accents = self.do_lower_case if strip is None \
            else bool(strip)
        self.chinese = bool(tc.get("tokenize_chinese_chars", True))
        self.max_chars = 100

        def special(key, default):
            return _content(tc.get(key) or sm.get(key) or default)

        self.unk_token = special("unk_token", "[UNK]")
        self.sep_token = special("sep_token", "[SEP]")
        self.pad_token = special("pad_token", "[PAD]")
        self.cls_token = special("cls_token", "[CLS]")
        self.mask_token = special("mask_token", "[MASK]")
        extra = [_content(t) for t in (tc.get("additional_special_tokens")
                                       or sm.get("additional_special_tokens")
                                       or [])]
        specials = [self.unk_token, self.sep_token, self.pad_token,
                    self.cls_token, self.mask_token, *extra]

        # added tokens: content -> (id, flags)
        added: Dict[str, dict] = {}
        for idx, tok in sorted((tc.get("added_tokens_decoder") or {}).items(),
                               key=lambda kv: int(kv[0])):
            added[tok["content"]] = dict(tok, id=int(idx))
        for content, idx in sorted(_read_json(os.path.join(
                path, "added_tokens.json")).items(), key=lambda kv: kv[1]):
            if content not in added:
                sp = content in specials
                added[content] = dict(content=content, id=int(idx),
                                      special=sp, normalized=not sp)
        n_ids = max([self.vocab_size] + [t["id"] + 1 for t in added.values()])
        for content in specials:
            if content not in added:
                idx = self.vocab.get(content)
                if idx is None:
                    idx, n_ids = n_ids, n_ids + 1
                added[content] = dict(content=content, id=idx, special=True,
                                      normalized=False)
        self.added = added
        self.ids = dict(self.vocab)
        self.ids.update({c: t["id"] for c, t in added.items()})
        self.pad_token_id = self.ids[self.pad_token]
        self.unk_token_id = self.ids[self.unk_token]
        self.double_sep = (family == "xlm-roberta")
        self._raw_split = self._splitter(
            [t for t in added.values() if not t.get("normalized", False)])
        self._norm_split = self._splitter(
            [t for t in added.values() if t.get("normalized", False)])

    def __len__(self) -> int:
        return len(self.ids)

    @staticmethod
    def _splitter(tokens):
        """A regex matching any of ``tokens`` (longest first), honouring
        their ``lstrip``, ``rstrip`` and ``single_word`` flags; None if
        there are none."""
        if not tokens:
            return None
        alts = []
        for t in sorted(tokens, key=lambda t: -len(t["content"])):
            pat = re.escape(t["content"])
            if t.get("single_word"):
                pat = r"(?<!\w)" + pat + r"(?!\w)"
            if t.get("lstrip"):
                pat = r"\s*" + pat
            if t.get("rstrip"):
                pat = pat + r"\s*"
            alts.append(f"(?P<t{len(alts)}>{pat})")
        rx = re.compile("|".join(alts))
        names = [t["content"] for t in
                 sorted(tokens, key=lambda t: -len(t["content"]))]
        return rx, names

    @staticmethod
    def _split(text: str, splitter):
        """[(piece, is_added_token_content or None)] of ``text``."""
        if splitter is None:
            return [(text, None)]
        rx, names = splitter
        out, pos = [], 0
        for m in rx.finditer(text):
            if m.start() > pos:
                out.append((text[pos:m.start()], None))
            out.append((m.group(), names[m.lastindex - 1]))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], None))
        return out

    def _normalize(self, text: str) -> str:
        return bert_normalize(text, self.do_lower_case, self.strip_accents,
                              self.chinese)

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        out, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            out.append(cur)
            start = end
        return out

    def tokenize(self, word: str) -> List[str]:
        out: List[str] = []
        for piece, tok in self._split(word, self._raw_split):
            if tok is not None:
                out.append(tok)
                continue
            for p, t in self._split(self._normalize(piece), self._norm_split):
                if t is not None:
                    out.append(t)
                    continue
                for w in bert_words(p):
                    out += self._wordpiece(w)
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.ids.get(t, self.unk_token_id) for t in tokens]


class HFTokenizerAdapter(BaseTokenizer):
    """Adapter over a transformers tokenizer (local files only);
    ``transformers`` is imported here, not with the module."""

    def __init__(self, name_or_path: str, family: str | None = None):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(
            name_or_path, local_files_only=True
        )
        self.cls_token = self._tok.cls_token
        self.sep_token = self._tok.sep_token
        self.pad_token = self._tok.pad_token
        self.pad_token_id = self._tok.pad_token_id
        self.vocab_size = self._tok.vocab_size
        self.double_sep = (family == "xlm-roberta")

    def tokenize(self, word: str) -> List[str]:
        return self._tok.tokenize(word)

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return self._tok.convert_tokens_to_ids(list(tokens))


def load_tokenizer(pre_trained_model: str | None,
                   tod_pre_trained_model: str | None,
                   memory: Memory, *,
                   require_pretrained: bool = False) -> BaseTokenizer:
    """The tokenizer of a run, as JAX's ``load_tokenizer`` resolves it
    (`n_best_asr_bert.py:480-487`): the checkpoint's when a pretrained
    model is requested -- ``WordPieceTokenizer`` for a BERT-family
    directory (``is_bert_family_dir``), ``HFTokenizerAdapter`` otherwise
    -- else the word-vocab tokenizer.  A requested tokenizer that fails to
    load raises under ``require_pretrained`` and otherwise warns on stderr
    and falls back to the word-vocab tokenizer, with JAX's messages."""
    requested = tod_pre_trained_model or (
        HF_NAMES.get(pre_trained_model) if pre_trained_model else None)
    if pre_trained_model and pre_trained_model not in HF_NAMES \
            and not tod_pre_trained_model:
        raise ValueError(
            f"unknown --pre_trained_model {pre_trained_model!r}; "
            f"choices: {sorted(HF_NAMES)}")
    if requested:
        try:
            if tod_pre_trained_model:
                path, family = tod_pre_trained_model, None
            else:
                path, family = resolve_checkpoint(requested), \
                    pre_trained_model
            if is_bert_family_dir(path):
                return WordPieceTokenizer(path, family=family)
            return HFTokenizerAdapter(path, family=family)
        except Exception as e:
            msg = (f"could not load pretrained tokenizer {requested!r}: "
                   f"{type(e).__name__}: {e}")
            if require_pretrained:
                raise RuntimeError(
                    msg + " (--require_pretrained set; refusing the "
                    "from-scratch fallback)") from e
            print(
                "WARNING: %s\nWARNING: falling back to the from-scratch "
                "word-vocab tokenizer — this run will NOT use pretrained "
                "weights. Pass --require_pretrained to make this fatal."
                % msg, file=sys.stderr, flush=True)
    return WordVocabTokenizer(memory)
