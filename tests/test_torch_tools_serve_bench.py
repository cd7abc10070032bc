"""The port's ``tools/serve_bench.py`` on the CPU on a synthetic
``REF_RAW``, its model constructor patched to 2 narrow layers: one JSON
line with the JAX tool's keys (read from its source) plus ``device``,
under ``--quantize none``, ``--quantize int8`` and ``--tokenizer
wordpiece``; ``native_pack`` false under ``--no_native_pack``; without
CUDA and without ``--platform cpu`` it raises."""

import json
import os
import re

import pytest
import torch

from nbest_asr_tpu_torch.models.encoder import EncoderConfig
from nbest_asr_tpu_torch.tools import serve_bench
from torch_tools_common import REPO, one_thread, ref_raw  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    return ref_raw(tmp_path_factory, n_sessions=80)


def _jax_keys():
    with open(os.path.join(REPO, "tools", "serve_bench.py")) as f:
        src = f.read()
    body = src[src.index("print(json.dumps({"):]
    return re.findall(r'^\s+"(\w+)":', body[:body.index("}))")], re.M)


def _small(vocab_size, fused):
    return EncoderConfig(vocab_size=vocab_size, hidden_size=128,
                         num_layers=2, num_heads=2, intermediate_size=256,
                         compute_dtype="bfloat16", use_fused_attn=fused,
                         use_fused_ffn=fused)


@pytest.mark.parametrize("flags,want", [
    ([], {"quantize": "none", "tokenizer": "word", "native_pack": True}),
    (["--quantize", "int8"], {"quantize": "int8"}),
    (["--tokenizer", "wordpiece"], {"tokenizer": "wordpiece",
                                     "native_pack": True}),
    (["--no_native_pack"], {"native_pack": False}),
], ids=["none", "int8", "wordpiece", "no_native_pack"])
def test_serve_bench_json_line(flags, want, raw, monkeypatch, capsys):
    monkeypatch.setattr(serve_bench, "REF_RAW", raw)
    monkeypatch.setattr(serve_bench, "model_config", _small)
    assert serve_bench.main(["--platform", "cpu", "--batch", "16",
                             "--iters", "3", *flags]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    keys = _jax_keys()
    assert len(keys) == 11 and "latency_p95_ms" in keys
    assert list(rec) == keys + ["device"]
    assert rec["device"] == "cpu" and rec["batch"] == 16
    assert rec["metric"] == "dstc2_serving"
    for k, v in want.items():
        assert rec[k] == v, k
    for k in ("latency_p50_ms", "latency_p95_ms", "utterances_per_sec",
              "async_depth2_utterances_per_sec"):
        assert rec[k] > 0, k


def test_serve_bench_refuses_without_cuda(raw, monkeypatch):
    monkeypatch.setattr(serve_bench, "REF_RAW", raw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="serve_bench runs on an NVIDIA"):
        serve_bench.main([])
