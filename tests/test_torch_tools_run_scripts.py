"""The port's ``run/`` scripts (``nbest_asr_tpu_torch/run/*.sh``) against
the JAX package's ``run/*.sh`` on the CPU: each script, run by bash with a
stand-in ``python`` on PATH that records its arguments, calls ``python -m
nbest_asr_tpu_torch.cli`` where JAX's calls ``python -m
nbest_asr_tpu.cli``, and the port's ``parse_arguments`` reads its flags
into the options JAX's reads from JAX's script (no flag is TPU-only, so
none is dropped); ``seed_sweep.sh`` runs the twin of
``train_eval_nbest_asr_tpu.sh`` once per seed, 999 to 1003."""

import dataclasses
import os
import shlex
import subprocess

import pytest

from nbest_asr_tpu.config import parse_arguments as j_parse
from nbest_asr_tpu_torch.config import parse_arguments

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("train_eval_nbest_asr_tpu.sh", "train_fast_tpu.sh",
           "seed_sweep.sh")


def _calls(script, tmp_path, *args):
    """The argument lists ``script`` passes to ``python``, one a call."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    record = tmp_path / "calls.txt"
    fake = bin_dir / "python"
    fake.write_text('#!/usr/bin/env bash\nprintf "%q " "$@" >> '
                    f'{shlex.quote(str(record))}\necho >> '
                    f'{shlex.quote(str(record))}\n')
    fake.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}")
    subprocess.run(["bash", script, *args], check=True, env=env,
                   timeout=60)
    calls = [shlex.split(x) for x in record.read_text().splitlines()]
    record.unlink()
    return calls


@pytest.mark.parametrize("name", SCRIPTS)
def test_run_script_twin_parses_as_jax(name, tmp_path):
    jcalls = _calls(os.path.join(REPO, "run", name), tmp_path, "/data",
                    *(["7"] if name != "seed_sweep.sh" else []))
    tcalls = _calls(os.path.join(REPO, "nbest_asr_tpu_torch", "run", name),
                    tmp_path, "/data",
                    *(["7"] if name != "seed_sweep.sh" else []))
    assert len(tcalls) == len(jcalls) == (5 if name == "seed_sweep.sh"
                                          else 1)
    seeds = []
    for got, want in zip(tcalls, jcalls):
        assert want[:2] == ["-m", "nbest_asr_tpu.cli"]
        assert got[:2] == ["-m", "nbest_asr_tpu_torch.cli"]
        assert got[2:] == want[2:]
        opt, jopt = parse_arguments(got[2:]), j_parse(want[2:])
        assert dataclasses.asdict(opt) == dataclasses.asdict(jopt)
        assert opt.dataroot == "/data" and opt.compute_dtype == "bfloat16"
        seeds.append(opt.random_seed)
    assert seeds == ([999, 1000, 1001, 1002, 1003]
                     if name == "seed_sweep.sh" else [7])
