"""The port's GPU twin of ``tools/tpu_kernel_check.py``
(``nbest_asr_tpu_torch/tools/gpu_kernel_check.py``) on the CPU: without
CUDA it returns 2 and writes no record; its check names are the JAX
tool's 80 (``TPUCHECK.json``) in their order, plus the port's own, minus
none; its kernel map covers every ``_cuda.KERNELS`` entry; and with
``--platform cpu`` every check runs on the plain versions and passes (the
kernel path is the plain version there, so the differences are those of
the Functions' backwards against autograd through the plain block)."""

import json
import os

import pytest
import torch

from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.tools import gpu_kernel_check as gkc
from torch_tools_common import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.usefixtures("one_thread")


def test_refuses_without_cuda_and_writes_no_record(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert gkc.main(["--record"]) == 2
    assert gkc.main(["--record", str(tmp_path / "x.json")]) == 2
    assert gkc.main([]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []
    # the CPU rehearsal writes no record that could read as a pass either
    assert gkc.main(["--platform", "cpu", "--record"]) == 2
    assert os.listdir(tmp_path) == []


def test_check_names_are_jax_s_plus_the_port_s():
    with open(os.path.join(REPO, "TPUCHECK.json")) as f:
        jax_names = [c["name"] for c in json.load(f)["checks"]]
    assert len(jax_names) == 80
    assert gkc.OMITTED == {}
    assert list(gkc.JAX_CHECKS) == [n for n in jax_names
                                    if n not in gkc.OMITTED]
    assert set(gkc.PORT_CHECKS) <= set(gkc.CHECK_NAMES)
    assert not set(gkc.PORT_CHECKS) & set(jax_names)
    assert len(set(gkc.CHECK_NAMES)) == len(gkc.CHECK_NAMES) == 87
    assert set(gkc.CUDA_ONLY) <= set(gkc.PORT_CHECKS)


def test_kernel_map_covers_every_kernel():
    assert sorted(gkc.COVERAGE) == sorted(_cuda.KERNELS)
    assert set(gkc.COVERAGE.values()) <= set(gkc.CHECK_NAMES)


def test_every_check_passes_on_the_plain_versions(capsys):
    c = gkc.run_checks(torch.device("cpu"))
    assert not c.failures, c.failures
    assert [r["name"] for r in c.results] == [
        n for n in gkc.CHECK_NAMES if n not in gkc.CUDA_ONLY]
    out = capsys.readouterr().out
    assert out.count("PASS  ") == len(c.results) and "FAIL" not in out
    # nothing was launched on the CPU
    assert all(not r["launches"] for r in c.results)


def test_tolerances_are_jax_s():
    """``check`` keeps JAX's atol (plus two bf16 ulps of the largest
    |want| where both tensors are bf16), ``check_rel`` its rtol; a
    determinism check is exact."""
    c = gkc.Checks()
    want = torch.tensor([1.0, 2.0])
    c.check("a", want + 5e-5, want, 1e-4)
    c.check("b", want + 2e-4, want, 1e-4)
    bf = want.to(torch.bfloat16)
    c.check("c", bf + 2.0 ** -6, bf, 1e-4)      # within 2 ulps of 2.0
    c.check("d", bf + 2.0 ** -4, bf, 1e-4)
    c.check("e", bf + 2.0 ** -6, bf, 0.0)
    c.check_rel("f", want * 1.01, want, 0.02)
    c.check_rel("g", want * 1.03, want, 0.02)
    assert c.failures == ["b", "d", "e", "g"]
