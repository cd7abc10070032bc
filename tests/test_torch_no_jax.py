"""The port never imports JAX or the JAX package: every module of the
port, and what ``chip_smoke.py``, ``chip_time_attention.py`` and
``chip_kernel_probe.py`` import,
loads in a fresh interpreter
with neither ``jax`` nor any ``nbest_asr_tpu`` module (as distinct from
``nbest_asr_tpu_torch``) in ``sys.modules``, as they must on a machine
that has no JAX at all -- and with no ``transformers``, ``tokenizers`` or
``safetensors``, which the card's machine lacks too."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

PROBE = """
import importlib, pathlib, sys
import nbest_asr_tpu_torch
pkg = pathlib.Path(nbest_asr_tpu_torch.__file__).parent
mods = sorted(
    "nbest_asr_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
    for p in pkg.rglob("*.py") if p.name != "__init__.py")
for m in mods:
    importlib.import_module(m)
import chip_smoke
import chip_time_attention
import chip_kernel_probe
chip_smoke.dstc2_like_memory()
from nbest_asr_tpu_torch import serve
assert nbest_asr_tpu_torch.Predictor is serve.Predictor
print("MODULES=" + str(len(mods)))
print("NAMES=" + ",".join(mods))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "nbest_asr_tpu"))
print("FORBIDDEN=" + ",".join(bad))
hf = sorted(m for m in sys.modules
            if m.split(".")[0] in ("transformers", "tokenizers", "safetensors"))
print("HF=" + ",".join(hf))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN=\n" in proc.stdout, proc.stdout
    # the pretrained path reads checkpoints and BERT's tokenizer itself:
    # importing it loads no transformers, tokenizers or safetensors
    assert "HF=\n" in proc.stdout, proc.stdout
    n = int(proc.stdout.split("MODULES=")[1].split()[0])
    assert n >= 55, proc.stdout     # the tools of the JAX package too
    names = proc.stdout.split("NAMES=")[1].split()[0].split(",")
    for m in ("parallel.mesh", "parallel.data_sharding",
              "parallel.process_data", "parallel.train_step",
              "tools.pretrain_mlm", "tools.run_etl", "tools.convert_memory",
              "data.wordpiece_trainer", "utils.profiling",
              "tools.gpu_kernel_check", "tools.serve_bench",
              "tools.serving_quality", "tools.quality_smoke",
              "tools.quality_sweep", "tools.quality_aggregate",
              "tools.perf_probe"):
        assert "nbest_asr_tpu_torch." + m in names, m
