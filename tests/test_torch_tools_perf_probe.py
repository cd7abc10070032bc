"""The port's ``tools/perf_probe.py`` on the CPU at ``--batch 2 --seq 64
--platform cpu`` (the encoder patched to 2 narrow layers, one timed call a
part, the hierarchy from a synthetic ``memory.pt``): each ``--what`` part
prints the JAX tool's labels (``[opt]``, ``[attn fwd]`` /
``[attn fwd+bwd]`` with and without ``drop``, ``[step]``, the nine
``[ablate]`` legs) and returns their times; ``--int8_train_bwd`` implies
``--int8_train`` and both block flags; without CUDA it raises."""

import os
import re

import pytest
import torch

from nbest_asr_tpu_torch.models.encoder import EncoderConfig
from nbest_asr_tpu_torch.tools import perf_probe
from torch_tools_common import REPO, one_thread, ref_raw  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    return ref_raw(tmp_path_factory, n_sessions=40)


def _small(args):
    return EncoderConfig(vocab_size=30522, hidden_size=128, num_layers=2,
                         num_heads=2, intermediate_size=256,
                         compute_dtype="bfloat16",
                         use_flash_attention=args.flash_step,
                         use_fused_ffn=args.fused_ffn,
                         use_fused_attn=args.fused_attn,
                         use_int8_train=args.int8_train,
                         use_int8_train_attn=args.int8_train,
                         use_int8_train_bwd=args.int8_train_bwd,
                         remat=args.remat)


def _jax_ablate_legs():
    with open(os.path.join(REPO, "tools", "perf_probe.py")) as f:
        src = f.read()
    return re.findall(r'\("([\w\-+ ]+?)\s*", ', src[src.index("legs = ["):])


@pytest.mark.parametrize("what,flags,labels", [
    ("opt", [], ["[opt]"]),
    ("attn", [], ["[attn fwd] plain", "[attn fwd+bwd] plain",
                  "[attn fwd] flash", "[attn fwd+bwd] flash"]),
    ("attn", ["--flash_dropout"], ["[attn fwd drop] plain",
                                   "[attn fwd+bwd drop] flash"]),
    ("step", ["--fused_attn", "--fused_ffn"], ["[step]"]),
    ("step", ["--int8_train_bwd", "--remat", "--dual_stream"], ["[step]"]),
    ("ablate", ["--flash_step"], None),
], ids=["opt", "attn", "attn_drop", "step", "step_int8", "ablate"])
def test_perf_probe_prints_jax_labels(what, flags, labels, raw,
                                      monkeypatch, capsys):
    monkeypatch.setattr(perf_probe, "MEMORY_PT",
                        os.path.join(raw, "memory.pt"))
    monkeypatch.setattr(perf_probe, "model_config", _small)
    monkeypatch.setattr(perf_probe, "ITERS", dict.fromkeys(
        perf_probe.ITERS, 1))
    out = perf_probe.run(perf_probe.parse_args(
        ["--batch", "2", "--seq", "64", "--platform", "cpu", "--what", what,
         *flags]))
    printed = capsys.readouterr().out
    assert printed.startswith("params: ")
    if labels is None:
        legs = _jax_ablate_legs()
        assert len(legs) == 9 and "gemm-skel fwd+bwd" in legs
        labels = [f"[ablate] {leg}" for leg in legs]
    for label in labels:
        assert label in out and out[label] > 0, label
        assert label in printed, label
    assert all(k.startswith(tuple(label.split("]")[0] for label in labels))
               for k in out)


def test_perf_probe_flags_and_refusal(monkeypatch):
    args = perf_probe.parse_args(["--int8_train_bwd"])
    assert args.int8_train and args.fused_attn and args.fused_ffn
    assert perf_probe.model_config(args).use_int8_train_attn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="perf_probe runs on an NVIDIA"):
        perf_probe.main(["--what", "opt"])
