"""The port's ``tools/quality_smoke.py`` against the JAX package's on the
CPU: both tools split the same synthetic ``valid`` shard (``REF_RAW``
pointed at it), train through their CLIs from one tiny
``--tod_pre_trained_model`` checkpoint at dropout 0 in f32 (``--extra``;
JAX's head bridged into the port), and print ``best.json`` as their last
line.  Tolerance: the same keys and best epoch, every metric within 1e-4
relative."""

import json
import os

import numpy as np
import pytest

from nbest_asr_tpu_torch.tools import quality_smoke
from torch_tools_common import (EXTRA, bridge_jax_head, jax_tool,  # noqa: F401
                                one_thread, ref_raw, run_jax_tool,
                                tod_checkpoint)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    return ref_raw(tmp_path_factory)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_quality_smoke_best_json_matches_jax(raw, tmp_path, capsys,
                                             monkeypatch):
    ckpt = tod_checkpoint(raw, tmp_path / "ckpt")
    argv = ["--epochs", "3", "--seed", "999",
            "--extra", EXTRA.format(ckpt)]
    jtool = jax_tool("quality_smoke")
    monkeypatch.setattr(jtool, "REF_RAW", raw)
    monkeypatch.setattr(quality_smoke, "REF_RAW", raw)
    bridge_jax_head(monkeypatch, 999)
    assert run_jax_tool(jtool, argv + ["--out", str(tmp_path / "j")],
                        monkeypatch, tmp_path) == 0
    want = _last_json(capsys.readouterr().out)
    assert quality_smoke.main(argv + ["--out", str(tmp_path / "t"),
                                      "--platform", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert sorted(got) == sorted(want)
    assert got["epoch"] == want["epoch"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    # the same split, and the report names the device
    for name in ("train", "valid", "test", "memory.json"):
        with open(tmp_path / "j" / "dataroot" / name) as a, \
                open(tmp_path / "t" / "dataroot" / name) as b:
            assert b.read() == a.read(), name
    md = (tmp_path / "t" / "QUALITY.md").read_text()
    assert "on the CPU" in md and f"{want['vf']:.2f}" in md


def test_quality_smoke_refuses_without_cuda_and_without_shard(tmp_path,
                                                              monkeypatch):
    """No ``--platform cpu`` and no CUDA: it raises, as the port's CLI
    does; a missing shard returns 2 as JAX's tool does."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quality_smoke.main(["--out", str(tmp_path)])
    monkeypatch.setattr(quality_smoke, "REF_RAW", str(tmp_path / "none"))
    assert quality_smoke.main(["--out", str(tmp_path),
                               "--platform", "cpu"]) == 2
    assert not os.path.exists(tmp_path / "dataroot")
