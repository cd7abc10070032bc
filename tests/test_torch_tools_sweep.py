"""The port's ``tools/quality_sweep.py`` and ``tools/quality_aggregate.py``
against the JAX package's on the CPU.  (d) Both sweeps over the same
seeds, arms and coverage points, with the per-run subprocess and the
clock stubbed: the same command lines (``python -m
nbest_asr_tpu_torch.tools.quality_smoke ... --platform cpu`` in place of
``tools/quality_smoke.py ...``), the same log lines and printed lines, and
a second run skips what the log holds.  (e) Both aggregators print the
same bytes for one log."""

import json
import subprocess
import sys

import pytest

from nbest_asr_tpu_torch.tools import quality_aggregate, quality_sweep
from torch_tools_common import jax_tool

BEST = {"epoch": 3, "vf": 81.25, "tef": 79.5, "v_acc": 70.0,
        "te_acc": 68.75}


def _stub(monkeypatch, calls):
    """Both tools' per-run subprocess and clock (one ``subprocess`` and
    one ``time`` module serve both)."""
    def run(cmd, capture_output, text):
        calls.append(list(cmd))
        seed = int(cmd[cmd.index("--seed") + 1])
        if seed == 1000 and "--coverage" in cmd:
            return subprocess.CompletedProcess(cmd, 1, "", "boom\n")
        best = dict(BEST, vf=BEST["vf"] + seed % 7)
        return subprocess.CompletedProcess(
            cmd, 0, "log line\n" + json.dumps(best) + "\n", "")

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(quality_sweep.time, "time", lambda: 100.0)


@pytest.mark.parametrize("flags", [
    [],
    ["--skip_coverage", "--arms", "shipping", "--lr", "1e-4"],
    ["--pretrained", "/ckpt", "--arm_extra=--int8_train",
     "--base_extra=--n_layers 12"],
], ids=["both_protocols", "one_arm", "pretrained"])
def test_sweep_runs_and_logs_as_jax(flags, tmp_path, monkeypatch, capsys):
    jtool = jax_tool("quality_sweep")
    calls = []
    _stub(monkeypatch, calls)
    args = ["--seeds", "999-1000", "--cov_seeds", "999-1000", "--epochs",
            "2", *flags]
    jlog, tlog = tmp_path / "j" / "r.jsonl", tmp_path / "t" / "r.jsonl"
    monkeypatch.setattr(sys, "argv", ["quality_sweep.py", "--log",
                                      str(jlog), *args])
    assert jtool.main() == 0
    jout = capsys.readouterr().out
    jcalls = calls[:]
    calls.clear()
    targv = ["--log", str(tlog), *args, "--platform", "cpu"]
    assert quality_sweep.main(targv) == 0
    tout = capsys.readouterr().out
    assert tout == jout
    tcalls = calls[:]
    assert len(tcalls) == len(jcalls) > 1
    for got, want in zip(tcalls, jcalls):
        assert want[:2] == [sys.executable, jtool.os.path.join(
            jtool.REPO, "tools/quality_smoke.py")]
        want = quality_sweep.SMOKE + want[2:] + ["--platform", "cpu"]
        assert got == [a.replace(str(tmp_path / "t"), str(tmp_path / "j"))
                       for a in want] or got == [
            a.replace(str(tmp_path / "j"), str(tmp_path / "t"))
            for a in want]
    assert tlog.read_text() == jlog.read_text()
    # resumable: a second sweep reruns only the failed runs
    n_failed = sum(json.loads(x)["rc"] != 0
                   for x in tlog.read_text().splitlines())
    calls.clear()
    assert quality_sweep.main(targv) == 0
    assert len(calls) == n_failed
    capsys.readouterr()


def test_sweep_refuses_without_cuda(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="quality_sweep runs on an"):
        quality_sweep.main(["--log", str(tmp_path / "r.jsonl")])
    assert not (tmp_path / "r.jsonl").exists()


def _log(path):
    rows = []
    for i, seed in enumerate(range(999, 1009)):
        for extra in ("", "--no_fused_ffn --no_fused_attn"):
            rows.append({"seed": seed, "extra": extra, "coverage": None,
                         "wall_s": 10.0 + i, "rc": 0, "epoch": i % 4,
                         "vf": 80 + i * 0.37 + len(extra) % 3,
                         "v_acc": 70 + i * 0.11, "tef": 78 + i * 0.29
                         - len(extra) % 2, "te_acc": 66 + i * 0.5})
    for c in (0.05, 0.1, 0.2, 0.5):
        for seed in (999, 1000, 1001):
            rows.append({"seed": seed, "extra": "", "coverage": c,
                         "wall_s": 5.0, "rc": 0, "epoch": 1,
                         "vf": 40 + 60 * c + seed % 3, "v_acc": 30.0,
                         "tef": 35 + 70 * c - seed % 2, "te_acc": 20.0})
    rows.append({"seed": 1, "extra": "--int8_train", "coverage": None,
                 "wall_s": 1.0, "rc": 0, "epoch": 0, "vf": 1.0,
                 "v_acc": 1.0, "tef": 1.0, "te_acc": 1.0})
    rows.append({"seed": 2, "extra": "", "coverage": None, "wall_s": 1.0,
                 "rc": 1, "stderr_tail": "x"})
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


@pytest.mark.parametrize("flags", [[], ["--arm", "custom=--int8_train"],
                                   ["--cov_extra=--x"]],
                         ids=["default", "arm", "cov_extra"])
def test_aggregate_prints_jax_s_bytes(flags, tmp_path, monkeypatch, capsys):
    log = _log(tmp_path / "r.jsonl")
    jtool = jax_tool("quality_aggregate")
    monkeypatch.setattr(sys, "argv", ["quality_aggregate.py", "--log", log,
                                      *flags])
    assert jtool.main() == 0
    want = capsys.readouterr().out
    assert quality_aggregate.main(["--log", log, *flags]) == 0
    got = capsys.readouterr().out
    assert got == want and "## arm protocol" in want
    assert ("Welch t" in want) == (not flags or flags[0] != "--arm")
