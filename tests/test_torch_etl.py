"""The port's offline data path against the JAX package's on the CPU: the
DSTC2 ETL (``nbest_asr_tpu_torch/data/etl.py`` and ``tools/run_etl.py``),
the memory converter (``tools/convert_memory.py``) and the native shard
packer (``data/native_loader.pack_file_native``).

The sessions come from ``chip_smoke.write_dstc2_sessions`` (seeded:
compound system acts, request and value slots, empty hypotheses, turns the
drop rule removes).  Tolerance: none -- the shards, ``memory.json`` and
``log`` must be byte-equal, the turn records and the packed arrays equal."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import write_dstc2_sessions
from nbest_asr_tpu.data import etl as jetl
from nbest_asr_tpu.data import native_loader as jnative
from nbest_asr_tpu.data.tokenizer import HFTokenizerAdapter
from nbest_asr_tpu.data.tokenizer import WordVocabTokenizer as JWordVocab
from nbest_asr_tpu.data.vocab import Memory as JMemory
from nbest_asr_tpu_torch.data import etl
from nbest_asr_tpu_torch.data import native_loader
from nbest_asr_tpu_torch.data.tokenizer import (WordPieceTokenizer,
                                                WordVocabTokenizer)
from nbest_asr_tpu_torch.data.vocab import Memory
from nbest_asr_tpu_torch.tools import convert_memory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("train", "valid", "test", "memory.json", "log")
CONFIGS = {"default": [], "augment": ["--augment", "--upsample_count", "2"],
           "dstc3": ["--dstc3"]}


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """40 DSTC2 sessions, and 40 with DSTC3's slots too."""
    d = tmp_path_factory.mktemp("dstc")
    write_dstc2_sessions(str(d / "dstc2"), 40, seed=3)
    write_dstc2_sessions(str(d / "dstc3"), 40, seed=4, dstc3=True)
    return d


def _raw(out):
    return os.path.join(out, "processed_data", "raw")


def _tool(argv):
    """A tool in a fresh interpreter with the hash seed fixed: the ETL
    orders the labels of dropped train turns by iterating a set of
    strings (``etl.py:run_etl``, JAX's code as it is), so its
    ``memory.json`` depends on ``PYTHONHASHSEED``."""
    proc = subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env=dict(os.environ, PYTHONHASHSEED="0"))
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("config", list(CONFIGS))
def test_run_etl_is_byte_equal_to_jax(config, sessions, tmp_path):
    """Both tools over the same raw sessions: the same printed line (up to
    the output directory) and byte-equal outputs."""
    data_dir = str(sessions / ("dstc3" if config == "dstc3" else "dstc2"))
    flags = CONFIGS[config]
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    want = _tool([os.path.join("tools", "run_etl.py"), "--data_dir",
                  data_dir, "--out_dir", jout, *flags])
    got = _tool(["-m", "nbest_asr_tpu_torch.tools.run_etl", "--data_dir",
                 data_dir, "--out_dir", tout, *flags])
    assert got.replace(tout, "<out>") == want.replace(jout, "<out>")
    for name in OUTPUTS:
        with open(os.path.join(_raw(jout), name), "rb") as a, \
                open(os.path.join(_raw(tout), name), "rb") as b:
            assert b.read() == a.read(), name
    with open(os.path.join(_raw(tout), "train")) as fp:
        assert sum(1 for _ in fp) > 0


def test_process_session_records_equal_jax(sessions):
    """Every session's turn records and vocab stats, both split maps,
    with and without the augmentation."""
    n = 0
    for tag, jmap, tmap in (("dstc2", jetl.SPLIT_MAP, etl.SPLIT_MAP),
                            ("dstc3", jetl.SPLIT_MAP_DSTC3,
                             etl.SPLIT_MAP_DSTC3)):
        assert tmap == jmap
        base = sessions / tag / "ori_data" / "Mar13_S0A0"
        for sid in sorted(os.listdir(base)):
            with open(base / sid / "log.json") as f:
                log = json.load(f)
            with open(base / sid / "label.json") as f:
                label = json.load(f)
            for aug in (False, True):
                jr, js = jetl.process_session(log, label, jmap, augment=aug,
                                              upsample_count=2)
                tr, ts = etl.process_session(log, label, tmap, augment=aug,
                                             upsample_count=2)
                assert [r.to_line() for r in tr] == \
                    [r.to_line() for r in jr]
                assert (ts.words, ts.labels, ts.sysact_tokens) == \
                    (js.words, js.labels, js.sysact_tokens)
                n += len(tr)
    assert n > 200


def test_convert_memory_matches_jax_tool(sessions, tmp_path):
    """A reference-format ``memory.pt`` (the reference's pickled dict,
    ``process_dstc2_with_SEP.py:427``) built from the ETL's memory: both
    tools write the same ``memory.json`` and print the same line."""
    out = str(tmp_path / "etl")
    etl.run_etl(str(sessions / "dstc2"), out)
    mem = Memory.load(os.path.join(_raw(out), "memory.json"))
    pt = tmp_path / "memory.pt"
    torch.save({
        "word2idx": mem.word2idx, "label2idx": mem.label2idx,
        "toplabel2idx": mem.toplabel2idx,
        "top2bottom_dict": mem.top2bottom, "sysact2idx": mem.sysact2idx,
        "act2idx": mem.act2idx, "slot2idx": mem.slot2idx,
        "value2idx": mem.value2idx, "single_acts": mem.single_acts,
        "double_acts": mem.double_acts, "triple_acts": mem.triple_acts,
    }, str(pt))
    jdst, tdst = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    want = _tool([os.path.join("tools", "convert_memory.py"), str(pt), jdst])
    got = _tool(["-m", "nbest_asr_tpu_torch.tools.convert_memory", str(pt),
                 tdst])
    assert got.replace(tdst, "<dst>") == want.replace(jdst, "<dst>")
    with open(jdst, "rb") as a, open(tdst, "rb") as b:
        assert b.read() == a.read()
    assert convert_memory.main([]) == 2


@pytest.fixture(scope="module")
def etl_root(sessions, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("etl_out"))
    etl.run_etl(str(sessions / "dstc2"), out)
    return _raw(out)


def _wordpiece_dir(path, memory):
    """BERT tokenizer files over the memory's words, with ``[SYS]`` /
    ``[USR]`` added past ``vocab.txt``, as ``BertTokenizer.save_pretrained``
    writes them."""
    from transformers import BertTokenizer

    os.makedirs(path, exist_ok=True)
    words = sorted({w.lower() for w in memory.word2idx if w.isalpha()})
    with open(os.path.join(path, "vocab.txt"), "w") as fp:
        fp.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                           + words + ["##s", "##ing"]) + "\n")
    tok = BertTokenizer(os.path.join(path, "vocab.txt"))
    tok.add_special_tokens({"additional_special_tokens": ["[SYS]", "[USR]"]})
    tok.save_pretrained(path)
    return path


@pytest.mark.skipif(not native_loader.native_available(),
                    reason="no C++ toolchain")
@pytest.mark.parametrize("tok,layout", [("word", "default"),
                                        ("word", "no_system_act"),
                                        ("wordpiece", "tod")])
def test_pack_file_native_matches_jax(tok, layout, etl_root, tmp_path):
    """The port's ``pack_file_native`` against JAX's on the ETL's train
    shard: the word-vocab tokenizer, and a WordPiece directory (the port's
    ``WordPieceTokenizer`` against JAX's ``transformers`` adapter), both
    with the shared max length left to the packer and fixed at 128."""
    mem = Memory.load(os.path.join(etl_root, "memory.json"))
    jmem = JMemory.load(os.path.join(etl_root, "memory.json"))
    if tok == "word":
        ttok, jtok = WordVocabTokenizer(mem), JWordVocab(jmem)
    else:
        path = _wordpiece_dir(str(tmp_path / "wp"), mem)
        ttok, jtok = WordPieceTokenizer(path), HFTokenizerAdapter(path)
    assert native_loader.native_supported(ttok)
    shard = os.path.join(etl_root, "train")
    for max_len in (None, 128):
        got = native_loader.pack_file_native(shard, mem, ttok, layout=layout,
                                             max_len=max_len)
        want = jnative.pack_file_native(shard, jmem, jtok, layout=layout,
                                        max_len=max_len)
        assert got.max_len == want.max_len
        for k in ("input_ids", "segment_ids", "attn_mask", "trans_input_ids",
                  "trans_segment_ids", "trans_attn_mask", "labels"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=k)
        assert got.raw_asr == want.raw_asr
        assert got.raw_labels == want.raw_labels
