"""Tokenizer interface and the whole-word tokenizer over the ETL word
vocab -- the port's copy of the part of ``nbest_asr_tpu/data/tokenizer.py``
it uses (``BaseTokenizer``, ``WordVocabTokenizer``).  The HF adapter stays
in the JAX package; any object with the ``BaseTokenizer`` attributes
serves.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .. import constants as C
from .vocab import Memory


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
