"""The port never imports JAX: its package and serving module load in a
fresh interpreter with ``jax`` absent from ``sys.modules``, as they must
on a machine that has no JAX at all."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

PROBE = """
import sys
import nbest_asr_tpu_torch
from nbest_asr_tpu_torch import serve, params_bridge
from nbest_asr_tpu_torch.ops import (_cuda, attention, fused_attention,
                                     fused_ffn, int8_serving, kernels,
                                     layers, quant)
from nbest_asr_tpu_torch.models import encoder, heads, model
from nbest_asr_tpu_torch.train import decode, metrics
assert nbest_asr_tpu_torch.Predictor is serve.Predictor
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print("JAX_MODULES=" + ",".join(bad))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_MODULES=\n" in proc.stdout, proc.stdout
