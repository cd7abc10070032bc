"""The port's tokenizers (``nbest_asr_tpu_torch/data/tokenizer.py``)
against ``transformers`` and the JAX package's
``nbest_asr_tpu/data/tokenizer.py`` on the CPU.

- ``WordPieceTokenizer``, read from a directory that
  ``BertTokenizer.save_pretrained`` wrote (``vocab.txt``,
  ``tokenizer_config.json``, ``special_tokens_map.json``,
  ``added_tokens.json``, with ``[SYS]`` and ``[USR]`` added past the
  vocab), gives ``AutoTokenizer``'s tokens and ids on the ``tiny_memory``
  corpus and on edge strings: accents, punctuation, CJK, the added
  tokens, empty strings, words over 100 characters; also with
  ``do_lower_case`` off and ``strip_accents`` set, and on the files
  ``tools/pretrain_mlm.py`` writes.
- ``pack_split`` rows with it equal JAX's with ``HFTokenizerAdapter``,
  bit for bit, in the default and TOD layouts.
- ``load_tokenizer``'s choices, errors and warnings equal JAX's."""

import json
import os

import numpy as np
import pytest

from nbest_asr_tpu.data import tokenizer as jtok
from nbest_asr_tpu.data.dataset import RawSplit as JRawSplit
from nbest_asr_tpu.data.input_builder import pack_split as j_pack_split
from nbest_asr_tpu_torch.data import tokenizer as ttok
from nbest_asr_tpu_torch.data.dataset import RawSplit
from nbest_asr_tpu_torch.data.input_builder import pack_split
from nbest_asr_tpu_torch.data.vocab import Memory

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
PIECES = ["un", "##want", "##ed", "##s", "##ing", "caf", "##e", "résumé",
          "resume", "中", "国", ",", ".", "!", "'", "-", "x", "##x"]
EDGE = ["", "   ", "I", "Unwanted,CHEAP!", "café", "CAFÉ", "Résumé",
        "résumé", "naïve", "中国x", "x中y", "x[SYS]y", "[SYS]", "[USR]",
        "[sys]", "[SYS][USR]", "[CLS]", "[MASK]s", "x" * 100, "x" * 101,
        "i\twant", "a​b", "a\x00b�", "don't", "e-mail",
        "¿qué?", "ÅNGSTRÖM", "wants", "wanting", "chinese", "Chinese"]


def _write_bert_dir(path, words, **tok_kw):
    from transformers import BertTokenizer

    os.makedirs(path, exist_ok=True)
    vocab = SPECIALS + sorted(set(words) | set(PIECES))
    with open(os.path.join(path, "vocab.txt"), "w") as fp:
        fp.write("\n".join(vocab) + "\n")
    tok = BertTokenizer(os.path.join(path, "vocab.txt"), **tok_kw)
    tok.add_special_tokens({"additional_special_tokens": ["[SYS]", "[USR]"]})
    tok.save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def bert_dir(tiny_memory, tmp_path_factory):
    words = [w for w in tiny_memory.word2idx if w.isalpha()]
    return _write_bert_dir(tmp_path_factory.mktemp("bert"), words)


def _auto(path):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path, local_files_only=True)


def _corpus(memory):
    words = list(memory.word2idx)
    return words + [w.upper() for w in words] + [w.capitalize()
                                                 for w in words]


def test_wordpiece_reads_the_directory_as_auto_tokenizer(bert_dir):
    got, want = ttok.WordPieceTokenizer(bert_dir), _auto(bert_dir)
    assert got.vocab_size == want.vocab_size
    assert len(got) == len(want)
    assert (got.cls_token, got.sep_token, got.pad_token, got.pad_token_id) \
        == (want.cls_token, want.sep_token, want.pad_token,
            want.pad_token_id)
    assert got.convert_tokens_to_ids(["[SYS]", "[USR]", "[MASK]", "zzz"]) \
        == want.convert_tokens_to_ids(["[SYS]", "[USR]", "[MASK]", "zzz"])
    assert got.convert_tokens_to_ids(["[SYS]"])[0] >= got.vocab_size
    assert not got.double_sep


@pytest.mark.parametrize("strings", ["corpus", "edge"])
def test_wordpiece_tokens_equal_auto_tokenizer(bert_dir, tiny_memory,
                                               strings):
    got, want = ttok.WordPieceTokenizer(bert_dir), _auto(bert_dir)
    cases = _corpus(tiny_memory) if strings == "corpus" else EDGE
    cases = cases + [" ".join(cases)]
    for s in cases:
        g, w = got.tokenize(s), want.tokenize(s)
        assert g == w, repr(s)
        assert got.convert_tokens_to_ids(g) == want.convert_tokens_to_ids(w)


@pytest.mark.parametrize("kw", [dict(do_lower_case=False),
                                dict(strip_accents=True,
                                     do_lower_case=False),
                                dict(strip_accents=False),
                                dict(tokenize_chinese_chars=False)],
                         ids=["cased", "cased_strip", "lower_keep_accents",
                              "no_cjk_split"])
def test_wordpiece_options_equal_auto_tokenizer(kw, tiny_memory, tmp_path):
    words = [w for w in tiny_memory.word2idx if w.isalpha()]
    path = _write_bert_dir(tmp_path, words + ["Chinese", "Café", "caf"],
                           **kw)
    got, want = ttok.WordPieceTokenizer(path), _auto(path)
    for s in EDGE + ["Chinese", "Café CAFÉ café"]:
        assert got.tokenize(s) == want.tokenize(s), repr(s)


def test_wordpiece_reads_pretrain_mlm_files(tmp_path):
    """``tools/pretrain_mlm.py``'s files: specials inside ``vocab.txt``,
    a ``tokenizer_config.json`` without ``added_tokens_decoder``."""
    vocab = SPECIALS + ["[SYS]", "[USR]", "i", "want", "food", "##s"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True,
         "model_max_length": 512}))
    (tmp_path / "special_tokens_map.json").write_text(json.dumps(
        {"pad_token": "[PAD]", "unk_token": "[UNK]", "cls_token": "[CLS]",
         "sep_token": "[SEP]", "mask_token": "[MASK]",
         "additional_special_tokens": ["[SYS]", "[USR]"]}))
    got, want = ttok.WordPieceTokenizer(str(tmp_path)), _auto(str(tmp_path))
    assert (got.vocab_size, len(got)) == (want.vocab_size, len(want))
    for s in ("[SYS]", "[USR]", "I WANT foods", "x[USR]want", "[sys]"):
        g = got.tokenize(s)
        assert g == want.tokenize(s), s
        assert got.convert_tokens_to_ids(g) == want.convert_tokens_to_ids(g)


def _raw(memory, seed=0, n=24):
    rng = np.random.RandomState(seed)
    words = [w for w in memory.word2idx if w.isalpha()]
    asr, labels = [], []
    for _ in range(n):
        hyps = [" ".join(rng.choice(words, rng.randint(1, 6)))
                for _ in range(rng.randint(1, 4))]
        asr.append(["[CLS]", "[SYS]", *rng.choice(words, 3), "[USR]",
                    *" [SEP] ".join(hyps).upper().split()])
        labels.append([memory.idx2label[2]])
    return asr, labels


@pytest.mark.parametrize("layout", ["default", "tod", "no_system_act"])
def test_pack_split_rows_equal_jax_with_hf_adapter(bert_dir, tiny_memory,
                                                   layout):
    tmem = Memory.from_json(tiny_memory.to_json())
    asr, labels = _raw(tiny_memory)
    want = j_pack_split(JRawSplit(asr, asr, labels),
                        jtok.HFTokenizerAdapter(bert_dir), tiny_memory,
                        layout=layout)
    got = pack_split(RawSplit(asr, asr, labels),
                     ttok.WordPieceTokenizer(bert_dir), tmem, layout=layout)
    assert got.max_len == want.max_len
    for k in ("input_ids", "segment_ids", "attn_mask", "trans_input_ids",
              "trans_segment_ids", "trans_attn_mask", "labels"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def _load(mod, capsys, *a, **kw):
    """(kind of tokenizer or error, its message, stderr) of ``load_tokenizer``."""
    try:
        tok = mod.load_tokenizer(*a, **kw)
        out = type(tok).__name__, None
    except (RuntimeError, ValueError) as e:
        out = type(e).__name__, str(e)
    return out + (capsys.readouterr().err,)


CHOICES = {
    "scratch": ((None, None), {}),
    "unknown_family": (("gpt2", None), {}),
    "bert_absent": (("bert", None), {}),
    "bert_absent_required": (("bert", None), {"require_pretrained": True}),
    "tod_absent": ((None, "/nonexistent/ckpt"), {}),
    "tod_absent_required": ((None, "/nonexistent/ckpt"),
                            {"require_pretrained": True}),
    "tod_bert": ((None, "BERT_DIR"), {"require_pretrained": True}),
    "bert_local": (("bert", None), {"require_pretrained": True}),
}


@pytest.mark.parametrize("case", list(CHOICES))
def test_load_tokenizer_errors_and_warnings_equal_jax(case, bert_dir,
                                                      tiny_memory, capsys,
                                                      monkeypatch, tmp_path):
    (pre, tod), kw = CHOICES[case]
    if tod == "BERT_DIR":
        tod = bert_dir
    if case == "bert_local":
        os.symlink(bert_dir, tmp_path / "bert-base-uncased")
        monkeypatch.setenv("NBEST_HF_LOCAL", str(tmp_path))
    else:
        monkeypatch.delenv("NBEST_HF_LOCAL", raising=False)
    tmem = Memory.from_json(tiny_memory.to_json())
    want = _load(jtok, capsys, pre, tod, tiny_memory, **kw)
    got = _load(ttok, capsys, pre, tod, tmem, **kw)
    port_kind = {"HFTokenizerAdapter": "WordPieceTokenizer"}
    assert got[0] == port_kind.get(want[0], want[0])
    assert got[1:] == want[1:]
    if case in ("tod_bert", "bert_local"):
        t = ttok.load_tokenizer(pre, tod, tmem, **kw)
        j = jtok.load_tokenizer(pre, tod, tiny_memory, **kw)
        for s in ("[SYS]", "I want CHINESE food", "[USR]"):
            assert t.convert_tokens_to_ids(t.tokenize(s)) == \
                j.convert_tokens_to_ids(j.tokenize(s))


def test_bert_family_rule(bert_dir, tmp_path):
    """WordPiece for every BERT-family directory; RoBERTa / XLM-R go to
    transformers."""
    assert ttok.is_bert_family_dir(bert_dir)
    plain = tmp_path / "plain"
    plain.mkdir()
    (plain / "vocab.txt").write_text("[PAD]\n[UNK]\n")
    assert not ttok.is_bert_family_dir(str(plain))
    (plain / "config.json").write_text(json.dumps({"model_type": "bert"}))
    assert ttok.is_bert_family_dir(str(plain))
    rob = tmp_path / "rob"
    rob.mkdir()
    (rob / "config.json").write_text(json.dumps({"model_type": "roberta"}))
    (rob / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "RobertaTokenizer"}))
    assert not ttok.is_bert_family_dir(str(rob))
    assert not ttok.is_bert_family_dir(str(tmp_path / "absent"))
