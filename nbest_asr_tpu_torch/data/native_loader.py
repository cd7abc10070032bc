"""ctypes bindings for the native (C++) shard loader/packer -- the port's
copy of ``nbest_asr_tpu/data/native_loader.py`` (``NativePacker`` :141,
``pack_file`` :230, ``pack_lines`` :244, ``pack_file_native`` :272); it
builds and loads the same ``native/nbest_loader.cpp``, into a library of
its own in the same ``native/build/``.

`native/nbest_loader.cpp` implements the offline tokenize+layout+pack pass
(the work the reference does in Python *per batch per epoch*,
`utils/bert_xlnet_inputs.py` / `n_best_asr_bert.py:249-250`) as a shared
library.  The Python word-vocab path (`input_builder.pack_split`) remains
the correctness oracle and the fallback when no C++ toolchain exists; a
parity test pins the two together.

Two entry points share one persistent `NativePacker` handle:
- ``pack_file``  -- shard file -> PackedSplit (the CLI's packer,
  ``cli.prepare_packed_splits``)
- ``pack_lines`` -- in-memory records -> PackedSplit (serving path; no
  filesystem touch, `nbl_load_buffer`)

Tokenizer scope:
- ``WordVocabTokenizer`` -- whole-word vocab lookup (from-scratch runs);
- BERT-family WordPiece: the port's own ``WordPieceTokenizer`` (every
  BERT-family checkpoint directory, no ``transformers``) whose accent
  stripping follows its lower-casing, as the C++ tokenizer's does, or a
  tokenizer adapter whose ``_tok`` is a transformers BertTokenizer /
  BertTokenizerFast -- native greedy longest-match subword tokenization
  with BasicTokenizer clean/lower/strip-accents/punct-split semantics,
  bit-parity-tested against transformers.  This covers the reference's
  primary pretrained path (`utils/bert_xlnet_inputs.py:46-53`) plus the
  in-repo MLM checkpoints (``tools/pretrain_mlm.py``).
- RoBERTa BPE / XLM-R SentencePiece adapters fall back to the Python
  packer (different sub-token algebras; offline-only paths).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

from .input_builder import PackedSplit, round_up
from .tokenizer import (BaseTokenizer, WordPieceTokenizer,
                        WordVocabTokenizer)
from .vocab import Memory

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "nbest_loader.cpp")
_LAYOUTS = {"default": 0, "no_system_act": 1, "tod": 2}

_lib_cache: Optional[ctypes.CDLL] = None


def build_library(force: bool = False) -> Optional[str]:
    """Compile the shared library (cached).  Returns the .so path or None
    when no toolchain is available.

    Processes that start together (the ranks of one run, test workers)
    may all build: each compiles to a name of its own and renames it onto
    the library, so none loads a file that another is still writing."""
    out_dir = os.path.join(_REPO, "native", "build")
    so_path = os.path.join(out_dir, "libnbest_loader_torch.so")
    if os.path.exists(so_path) and not force:
        if (os.path.getmtime(so_path) >= os.path.getmtime(_SRC)):
            return so_path
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC,
             "-o", tmp],
            check=True, capture_output=True)
        os.replace(tmp, so_path)
    except (OSError, subprocess.CalledProcessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so_path


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib_cache
    if _lib_cache is not None:
        return _lib_cache
    so = build_library()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.nbl_create.restype = ctypes.c_void_p
    lib.nbl_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_int32, ctypes.c_int32,
                               ctypes.c_int32, ctypes.c_int32,
                               ctypes.c_int32]
    lib.nbl_create_wordpiece.restype = ctypes.c_void_p
    lib.nbl_create_wordpiece.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_int32]
    lib.nbl_error.restype = ctypes.c_char_p
    lib.nbl_error.argtypes = [ctypes.c_void_p]
    lib.nbl_load.restype = ctypes.c_int32
    lib.nbl_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_int32]
    lib.nbl_load_buffer.restype = ctypes.c_int32
    lib.nbl_load_buffer.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int32]
    lib.nbl_max_len.restype = ctypes.c_int32
    lib.nbl_max_len.argtypes = [ctypes.c_void_p]
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.nbl_pack.restype = ctypes.c_int32
    lib.nbl_pack.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                             ctypes.c_int32, ctypes.c_int32,
                             i32p, i32p, f32p, i32p, i32p, f32p, f32p]
    lib.nbl_labels.restype = ctypes.c_char_p
    lib.nbl_labels.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.nbl_destroy.argtypes = [ctypes.c_void_p]
    _lib_cache = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def _bert_wordpiece_info(tokenizer: BaseTokenizer):
    """(ordered vocab list, do_lower_case, unk token) when ``tokenizer`` is
    BERT's WordPiece -- the port's ``WordPieceTokenizer`` with accents
    stripped exactly when it lower-cases, or an adapter over a BERT
    tokenizer -- else None."""
    if isinstance(tokenizer, WordPieceTokenizer):
        if tokenizer.strip_accents != tokenizer.do_lower_case:
            return None
        vocab = tokenizer.ids
        lower, unk = tokenizer.do_lower_case, tokenizer.unk_token
    else:
        tok = getattr(tokenizer, "_tok", None)
        if tok is None:
            return None
        try:
            from transformers import BertTokenizer, BertTokenizerFast
        except ImportError:
            return None
        if not isinstance(tok, (BertTokenizer, BertTokenizerFast)):
            return None
        vocab = tok.get_vocab()
        lower = bool(getattr(tok, "do_lower_case", True))
        unk = tok.unk_token
    inv = [None] * (max(vocab.values()) + 1)
    for t, i in vocab.items():
        inv[i] = t
    inv = [t if t is not None else f"[unused_gap{i}]"
           for i, t in enumerate(inv)]
    return inv, lower, unk


def native_supported(tokenizer: BaseTokenizer) -> bool:
    """Whether NativePacker can serve this tokenizer (word-vocab or BERT
    WordPiece); RoBERTa BPE / XLM-R SentencePiece adapters return False."""
    return isinstance(tokenizer, WordVocabTokenizer) or \
        _bert_wordpiece_info(tokenizer) is not None


class NativePacker:
    """Persistent handle over the C++ loader (vocab/labels loaded once)."""

    def __init__(self, memory: Memory, tokenizer: BaseTokenizer,
                 layout: str = "default"):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++?)")
        self._lib = lib
        self._memory = memory
        self._layout = _LAYOUTS[layout]
        self._n_labels = memory.n_bottom
        self._pad_id = tokenizer.pad_token_id
        with tempfile.TemporaryDirectory() as td:
            label_path = os.path.join(td, "labels.tsv")
            with open(label_path, "w") as fp:
                for l, i in memory.label2idx.items():
                    fp.write(f"{l}\t{i}\n")
            if isinstance(tokenizer, WordVocabTokenizer):
                vocab_path = os.path.join(td, "vocab.tsv")
                with open(vocab_path, "w") as fp:
                    for w, i in tokenizer.vocab.items():
                        fp.write(f"{w}\t{i}\n")
                sep_id = tokenizer.vocab[tokenizer.sep_token]
                self._h = lib.nbl_create(
                    vocab_path.encode(), label_path.encode(),
                    tokenizer.pad_token_id, 1,
                    tokenizer.vocab[tokenizer.cls_token], sep_id,
                    1 if tokenizer.double_sep else 0)
            else:
                info = _bert_wordpiece_info(tokenizer)
                if info is None:
                    raise RuntimeError(
                        "native packer supports WordVocabTokenizer and "
                        "BERT WordPiece tokenizers; "
                        f"got {type(tokenizer).__name__} over "
                        f"{type(getattr(tokenizer, '_tok', None)).__name__}")
                inv, lower, unk = info
                vocab_path = os.path.join(td, "vocab.txt")
                with open(vocab_path, "w") as fp:
                    fp.write("\n".join(inv) + "\n")
                ids = tokenizer.convert_tokens_to_ids
                unk_id = ids([unk])[0]
                self._h = lib.nbl_create_wordpiece(
                    vocab_path.encode(), label_path.encode(),
                    tokenizer.pad_token_id, unk_id,
                    ids([tokenizer.cls_token])[0],
                    ids([tokenizer.sep_token])[0],
                    1 if lower else 0,
                    1 if tokenizer.double_sep else 0)
        err = lib.nbl_error(self._h).decode()
        if err:
            lib.nbl_destroy(self._h)
            self._h = None
            raise RuntimeError(f"native loader: {err}")
        self._with_segments = 0 if layout == "no_system_act" else 1

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.nbl_destroy(self._h)
            self._h = None

    # ------------------------------------------------------------------ #
    def _pack_loaded(self, n: int, max_len: Optional[int],
                     len_multiple: int, raw_asr) -> PackedSplit:
        lib = self._lib
        if max_len is None:
            max_len = round_up(int(lib.nbl_max_len(self._h)), len_multiple)
        ids = np.empty((n, max_len), np.int32)
        segs = np.empty((n, max_len), np.int32)
        mask = np.empty((n, max_len), np.float32)
        t_ids = np.empty((n, max_len), np.int32)
        t_segs = np.empty((n, max_len), np.int32)
        t_mask = np.empty((n, max_len), np.float32)
        labels = np.empty((n, self._n_labels), np.float32)
        got = lib.nbl_pack(self._h, max_len, self._n_labels,
                           self._with_segments, ids, segs, mask, t_ids,
                           t_segs, t_mask, labels)
        assert got == n
        raw_labels = []
        for i in range(n):
            s = lib.nbl_labels(self._h, i).decode()
            raw_labels.append(s.split(";") if s else [])
        return PackedSplit(
            input_ids=ids, segment_ids=segs, attn_mask=mask,
            trans_input_ids=t_ids, trans_segment_ids=t_segs,
            trans_attn_mask=t_mask, labels=labels,
            raw_asr=raw_asr, raw_labels=raw_labels, max_len=max_len)

    def pack_file(self, shard_path: str, max_len: Optional[int] = None,
                  len_multiple: int = 8) -> PackedSplit:
        n = self._lib.nbl_load(self._h, shard_path.encode(), self._layout)
        if n < 0:
            raise RuntimeError(
                f"native loader: {self._lib.nbl_error(self._h).decode()}")
        raw_asr = []
        with open(shard_path) as fp:
            for line in fp:
                parts = line.strip("\n\r").split("\t<=>\t")
                if len(parts) == 3:
                    raw_asr.append(parts[0].strip().split(" "))
        return self._pack_loaded(n, max_len, len_multiple, raw_asr)

    def pack_lines(self, asr_seqs: Sequence[Sequence[str]],
                   trans_seqs: Optional[Sequence[Sequence[str]]] = None,
                   labels: Optional[Sequence[Sequence[str]]] = None,
                   max_len: Optional[int] = None,
                   len_multiple: int = 8) -> PackedSplit:
        """In-memory records -> PackedSplit (serving path, no files)."""
        if trans_seqs is None:
            trans_seqs = asr_seqs
        if labels is None:
            labels = [[] for _ in asr_seqs]
        buf = "".join(
            "%s\t<=>\t%s\t<=>\t%s\n" % (" ".join(a), " ".join(t),
                                        ";".join(l))
            for a, t, l in zip(asr_seqs, trans_seqs, labels))
        n = self._lib.nbl_load_buffer(self._h, buf.encode(), self._layout)
        if n < 0:
            raise RuntimeError(
                f"native loader: {self._lib.nbl_error(self._h).decode()}")
        if n != len(asr_seqs):
            # the C++ parser skips malformed records; for in-memory input
            # that would silently misalign outputs with inputs
            raise ValueError(
                f"{len(asr_seqs) - n} malformed records (missing [USR] "
                "marker or embedded newlines/tabs)")
        return self._pack_loaded(n, max_len, len_multiple,
                                 [list(a) for a in asr_seqs])


def pack_file_native(shard_path: str, memory: Memory,
                     tokenizer: BaseTokenizer,
                     layout: str = "default",
                     max_len: Optional[int] = None,
                     len_multiple: int = 8) -> PackedSplit:
    """One-shot wrapper (training/CLI path)."""
    packer = NativePacker(memory, tokenizer, layout)
    return packer.pack_file(shard_path, max_len, len_multiple)
