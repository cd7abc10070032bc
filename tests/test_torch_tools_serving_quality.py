"""The port's ``tools/serving_quality.py`` against the JAX package's on
the CPU: both train through their CLIs on the same synthetic split from
one tiny ``--tod_pre_trained_model`` checkpoint at dropout 0 in f32
(``--extra``; JAX's head bridged into the port), rebuild the config from
``config.json`` and serve the valid and test shards through each arm the
CPU has (``bf16_xla``, ``int8``).  Tolerance: every arm's F1, Acc and
agreement within 1e-4 relative of JAX's, and the same markdown table."""

import json

import numpy as np
import pytest

from nbest_asr_tpu_torch.tools import serving_quality
from torch_tools_common import (EXTRA, bridge_jax_head, jax_tool,  # noqa: F401
                                one_thread, ref_raw, run_jax_tool,
                                tod_checkpoint)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    return ref_raw(tmp_path_factory)


def test_serving_quality_arms_match_jax(raw, tmp_path, capsys, monkeypatch):
    ckpt = tod_checkpoint(raw, tmp_path / "ckpt")
    argv = ["--epochs", "2", "--seed", "999", "--extra", EXTRA.format(ckpt)]
    jtool = jax_tool("serving_quality")
    monkeypatch.setattr(jtool, "REF_RAW", raw)
    monkeypatch.setattr(serving_quality, "REF_RAW", raw)
    bridge_jax_head(monkeypatch, 999)
    jout, tout = tmp_path / "j", tmp_path / "t"
    assert run_jax_tool(jtool, argv + ["--out", str(jout)], monkeypatch,
                        tmp_path) == 0
    want_table = capsys.readouterr().out.strip().splitlines()[-8:]
    assert serving_quality.main(argv + ["--out", str(tout),
                                        "--platform", "cpu"]) == 0
    got_table = capsys.readouterr().out.strip().splitlines()[-6:]
    want = json.loads((jout / "serving_quality.json").read_text())
    got = json.loads((tout / "serving_quality.json").read_text())
    assert got["on_gpu"] is False and want["on_tpu"] is False
    assert sorted(got["results"]) == sorted(want["results"]) == [
        "test/bf16_xla", "test/int8", "valid/bf16_xla", "valid/int8"]
    for key, w in want["results"].items():
        for metric in ("f1", "acc", "agree_vs_bf16"):
            np.testing.assert_allclose(got["results"][key][metric],
                                       w[metric], rtol=1e-4,
                                       err_msg=f"{key} {metric}")
    assert got_table == want_table[-6:]
    # --reuse serves the trained run again without training
    assert serving_quality.main(argv + ["--out", str(tout), "--reuse",
                                        "--platform", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines() == got_table


def test_serving_quality_arms():
    """``build_arms``' counterparts: the plain bf16 arm, int8, and the
    attention kernels on the forward on the card only."""
    assert serving_quality.build_arms(False) == {
        "bf16_xla": dict(quantize="none", fused_attn_eval=False),
        "int8": dict(quantize="int8", fused_attn_eval=False)}
    arms = serving_quality.build_arms(True)
    assert list(arms) == ["bf16_xla", "int8", "fused_attn_eval"]
    assert arms["int8"]["fused_attn_eval"] is True
    assert serving_quality.PLAIN_ARMS == ("bf16_xla",)
    agree = serving_quality.agreement([["a"], ["b", "c"]], [["a"], ["c"]])
    assert agree == 50.0
    assert serving_quality.tuple_f1_acc([["a"]], [["a", "b"]]) == (
        2 * 100.0 * 50.0 / 150.0, 0.0)
