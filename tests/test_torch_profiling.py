"""The port's profiling utilities (``utils/profiling.py``) and the CLI's
``--profile_dir`` on the CPU: ``StepTimer``'s statistics (JAX's test,
``tests/test_profiling.py``), ``trace`` writing a Chrome trace that holds
an ``annotate`` span, and a two-epoch ``cli.main`` run whose epoch metrics
are the same with and without ``--profile_dir`` (no tolerance: the
profiler only observes; one thread, so that two runs sum alike), with one
trace file written, of the epoch JAX traces
(``nbest_asr_tpu/train/loop.py:655-662``)."""

import json
import os

import pytest
import torch

from chip_smoke import write_dstc2_sessions
from nbest_asr_tpu_torch import cli
from nbest_asr_tpu_torch.data.etl import run_etl
from nbest_asr_tpu_torch.train import loop as tloop
from nbest_asr_tpu_torch.utils.profiling import StepTimer, annotate, trace


def test_step_timer_summary():
    import time

    t = StepTimer(warmup=1)
    for _ in range(4):
        with t.step():
            time.sleep(0.01)
    s = t.summary()
    assert s["steps"] == 3
    assert 0.005 < s["mean_s"] < 0.5
    assert s["p95_s"] >= s["p50_s"]


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.ones(64, 64)
    with trace(logdir, device="cpu"):
        with annotate("matmul_phase"):
            torch.tanh(x) @ x
    (name,) = os.listdir(logdir)
    assert name.startswith("trace_") and name.endswith(".json")
    with open(os.path.join(logdir, name)) as fp:
        events = json.load(fp)["traceEvents"]
    assert any(e.get("name") == "matmul_phase" for e in events)
    assert any("mm" in e.get("name", "") for e in events)


@pytest.fixture
def one_thread():
    """CPU torch sums in thread order: one thread makes two runs equal."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_profile_dir_leaves_the_epochs_unchanged(tmp_path, monkeypatch,
                                                 one_thread):
    """Two epochs from a tiny checkpoint (hidden 64, its WordPiece vocab
    trained on the train shard), dropout 0.1, with and without
    ``--profile_dir``."""
    from nbest_asr_tpu_torch.data.dataset import read_sep_data
    from nbest_asr_tpu_torch.models.encoder import (EncoderConfig,
                                                    init_encoder_params)
    from nbest_asr_tpu_torch.models.hf_convert import export_hf_checkpoint
    from nbest_asr_tpu_torch.tools.pretrain_mlm import (corpus_lines,
                                                        train_wordpiece_vocab)

    data = tmp_path / "dstc2"
    write_dstc2_sessions(str(data), 24, seed=6)
    run_etl(str(data), str(tmp_path / "etl"))
    root = str(tmp_path / "etl" / "processed_data" / "raw")
    ckpt = str(tmp_path / "ckpt")
    vocab = train_wordpiece_vocab(corpus_lines(read_sep_data(
        os.path.join(root, "train"))), ckpt, 256)
    with open(vocab) as fp:
        n = sum(1 for _ in fp)
    cfg = EncoderConfig.tiny(n, max_position=512)
    export_hf_checkpoint(cfg, init_encoder_params(
        torch.Generator().manual_seed(0), cfg), ckpt)

    traced, log = [], []
    run_train = tloop.Trainer.run_train_epoch

    def train_epoch(self):
        m = run_train(self)
        log.append((m.mean_loss, m.precision, m.recall, m.f1, m.acc))
        traced.append(torch._C._autograd._profiler_enabled())
        return m

    monkeypatch.setattr(tloop.Trainer, "run_train_epoch", train_epoch)
    argv = ["--dataset", "dstc2", "--dataroot", root,
            "--tod_pre_trained_model", ckpt, "--require_pretrained",
            "--batchSize", "8", "--max_epoch", "2", "--bert_dropout", "0.1",
            "--eval_artifacts", "none", "--save_best", "none"]
    prof = str(tmp_path / "prof")
    runs = []
    for extra in ([], ["--profile_dir", prof]):
        log.clear()
        traced.clear()
        assert cli.main(argv + extra + ["--experiment",
                                        str(tmp_path / "exp")],
                        device="cpu") == 0
        runs.append(list(log))
        if extra:
            assert traced == [False, True]      # epoch 1, as JAX's
    assert runs[0] == runs[1] and len(runs[0]) == 2
    (name,) = os.listdir(prof)
    assert name.endswith(".json") and os.path.getsize(
        os.path.join(prof, name)) > 0
