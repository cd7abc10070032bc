"""The port's CLI trained by two gloo ranks on the CPU
(``torch_dist_worker.py cli``: ``cli.main(argv, device="cpu")`` in each
rank after it joins a ``file://``-store group), against one process and
against the JAX package's CLI.

The model is a tiny BERT checkpoint (``--tod_pre_trained_model``, hidden
32, two layers, two heads) with the head JAX's CLI draws, bridged into the
port, at dropout 0, two epochs.

- ``--data_mode direct`` on two ranks (dp = 2): each rank trains on its
  strided shard.  A rank's rows of a global micro are not a single
  process's (``parallel/process_data.py``), so the run takes a batch that
  holds each length bucket whole: every step then trains on the same rows
  as one process's.  Per epoch the train / valid / test loss, P, R, F1
  and Acc agree with one process and with JAX's CLI within 1e-4
  relative, the final parameters within 1e-4, and the two ranks'
  parameters are bit-equal.  Rank 1, given its own experiment directory,
  writes nothing there.
- Index mode on two ranks at a batch of 8 (several micros a bucket): each
  rank takes its half of every global micro; the same agreement with one
  process.
- ``--n_model_parallel 2`` on two ranks (tp = 2), with a checkpoint an
  epoch: the same agreement with one process; the checkpoint holds the
  full tree in the one-device format; resumed at tp = 1 from epoch 0's,
  the second epoch ends within 1e-4 of the one-process run; the best
  checkpoint loads in ``serve.load_predictor``."""

import os

import jax
import numpy as np
import pytest
import torch

from nbest_asr_tpu import cli as jcli
from nbest_asr_tpu.models import heads as jheads
from nbest_asr_tpu.train import loop as jloop
from nbest_asr_tpu_torch import cli
from nbest_asr_tpu_torch.params_bridge import from_jax_numpy, to_numpy
from nbest_asr_tpu_torch.train import loop as tloop
from test_torch_cli import (_run_dir, _write_dataroot,  # noqa: F401
                            tod_checkpoint)
from torch_dist_worker import flat, spawn

SEED = 5


def _argv(dataroot, ckpt, exp, batch=64):
    return ["--dataset", "dstc2", "--dataroot", dataroot,
            "--tod_pre_trained_model", ckpt, "--require_pretrained",
            "--n_layers", "2", "--batchSize", str(batch),
            "--length_buckets", "20,28,36", "--max_epoch", "2",
            "--lr", "1e-3", "--bert_lr", "1e-3", "--bert_dropout", "0",
            "--dropout", "0", "--random_seed", str(SEED),
            "--add_segment_ids", "--experiment", str(exp)]


def _jax_head(n_top, n_bottom):
    """The head JAX's ``build_model`` draws under the CLI's rbg PRNG."""
    saved = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "rbg")
    try:
        _, k_head = jax.random.split(jax.random.PRNGKey(SEED))
        return jax.device_get(jheads.init_head_params(k_head, 32, n_top,
                                                      n_bottom))
    finally:
        jax.config.update("jax_default_prng_impl", saved)


def _jax_cli(argv, tmp):
    """JAX's ``cli.main``, its process-wide PRNG and compile-cache settings
    put back."""
    saved = {k: getattr(jax.config, k) for k in (
        "jax_default_prng_impl", "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    os.environ["NBEST_ASR_TPU_CACHE"] = str(tmp / "jax_cache")
    try:
        return jcli.main(argv)
    finally:
        del os.environ["NBEST_ASR_TPU_CACHE"]
        for k, v in saved.items():
            jax.config.update(k, v)


def _recording(mp, trainer_cls, log, trainers):
    run_train, run_eval, train = (trainer_cls.run_train_epoch,
                                  trainer_cls.run_eval_epoch,
                                  trainer_cls.train)

    def train_epoch(self):
        m = run_train(self)
        log.append(("train", [m.mean_loss, m.precision, m.recall, m.f1,
                              m.acc]))
        return m

    def eval_epoch(self, split, *a, **kw):
        m, info = run_eval(self, split, *a, **kw)
        log.append((split, [m.mean_loss, m.precision, m.recall, m.f1,
                            m.acc]))
        return m, info

    def record(self, *a, **kw):
        trainers.append(self)
        return train(self, *a, **kw)

    mp.setattr(trainer_cls, "run_train_epoch", train_epoch)
    mp.setattr(trainer_cls, "run_eval_epoch", eval_epoch)
    mp.setattr(trainer_cls, "train", record)


def _port_run(argv, head):
    """One process: (epochs, final params as flat numpy)."""
    log, trainers = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop, "init_head_params", lambda *a, **k: dict(head))
        _recording(mp, tloop.Trainer, log, trainers)
        assert cli.main(argv, device="cpu") == 0
    return log, {k: v for k, v in flat(to_numpy(
        trainers[-1].state.params)).items()}


@pytest.fixture(scope="module")
def runs(tiny_memory, tod_checkpoint, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("mp")
    root = _write_dataroot(tmp / "dataroot", tiny_memory)
    head = from_jax_numpy(_jax_head(tiny_memory.n_top,
                                    tiny_memory.n_bottom))
    out = {}

    log, trainers = [], []               # JAX's CLI, one process
    with pytest.MonkeyPatch.context() as mp:
        _recording(mp, jloop.Trainer, log, trainers)
        assert _jax_cli(_argv(root, tod_checkpoint, tmp / "j"), tmp) == 0
    out["jax"] = (log, {k: np.asarray(v) for k, v in flat(
        jax.device_get(trainers[-1].state.params)).items()})

    arrays = {f"h/{k}": v.numpy() for k, v in flat(head).items()}
    for name, batch in (("one", 64), ("one_b8", 8)):
        out[name] = _port_run(_argv(root, tod_checkpoint, tmp / name, batch),
                              head)

    def two(name, batch, extra):
        argv = _argv(root, tod_checkpoint, tmp / name, batch) + extra
        spec = {"argv": argv, "rank_argv": {
            "1": ["--experiment", str(tmp / f"{name}_rank1")]}
            if "direct" in extra else {}}
        res = spawn("cli", 2, tmp / f"{name}_ranks", spec, arrays)
        assert all(js["rc"] == 0 for js, _ in res)
        out[name] = res

    two("direct", 64, ["--data_mode", "direct"])
    two("index", 8, [])
    two("tp2", 64, ["--n_model_parallel", "2", "--checkpoint_every", "1"])
    out["tmp"], out["root"], out["head"] = tmp, root, head
    return out


def _close_epochs(got, want, what):
    assert [k for k, _ in got] == [k for k, _ in want] == [
        "train", "valid", "test"] * 2, what
    for (split, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what} {split}")


def _close_params(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{what} {k}")


def test_direct_two_ranks_match_one_process_and_jax(runs):
    (js0, p0), (js1, p1) = runs["direct"]
    one_log, one_params = runs["one"]
    jax_log, jax_params = runs["jax"]
    for js in (js0, js1):
        epochs = [(k, v) for k, v in js["epochs"]]
        _close_epochs(epochs, one_log, "direct vs one process")
        _close_epochs(epochs, jax_log, "direct vs JAX")
    _close_epochs(one_log, jax_log, "one process vs JAX")
    _close_params(p0, one_params, "direct vs one process")
    _close_params(p0, jax_params, "direct vs JAX")
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


def test_index_two_ranks_match_one_process(runs):
    (js0, p0), (js1, p1) = runs["index"]
    one_log, one_params = runs["one_b8"]
    _close_epochs([(k, v) for k, v in js0["epochs"]], one_log,
                  "index vs one process")
    assert js0["epochs"] == js1["epochs"]
    _close_params(p0, one_params, "index vs one process")
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


def test_only_the_coordinator_writes(runs):
    tmp = runs["tmp"]
    files = [f for _, _, fs in os.walk(tmp / "direct_rank1") for f in fs]
    assert files == []
    names = set(os.listdir(_run_dir(tmp / "direct")))
    assert {"config.json", "best.json", "log.train", "valid.iter0",
            "test.iter1"} <= names
    assert names == set(os.listdir(_run_dir(tmp / "one")))


def test_tp2_checkpoint_resumes_at_tp1_and_serves(runs, tod_checkpoint):
    from nbest_asr_tpu_torch.config import parse_arguments
    from nbest_asr_tpu_torch.data.dataset import read_sep_data
    from nbest_asr_tpu_torch.data.tokenizer import load_tokenizer
    from nbest_asr_tpu_torch.serve import load_predictor

    tmp, root, head = runs["tmp"], runs["root"], runs["head"]
    exp = _run_dir(tmp / "tp2")
    ckpt = torch.load(os.path.join(exp, "ckpt_epoch0"), weights_only=True)
    one = runs["one"][1]
    got = {k: v.numpy() for k, v in flat(ckpt["params"]).items()}
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in one.items()}
    m = {k: v.numpy() for k, v in flat(ckpt["opt_state"]["m"]).items()}
    assert {k: v.shape for k, v in m.items()} == \
        {k: v.shape for k, v in one.items()}

    (js0, p0), (js1, p1) = runs["tp2"]
    _close_epochs([(k, v) for k, v in js0["epochs"]], runs["one"][0],
                  "tp2 vs one process")
    _close_params(p0, one, "tp2 vs one process")
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)

    # the second epoch again, at tp = 1, from the tp = 2 checkpoint
    log, params = _port_run(
        _argv(root, tod_checkpoint, tmp / "tp2_resumed") + [
            "--resume", os.path.join(exp, "ckpt_epoch0")], head)
    assert [k for k, _ in log] == ["train", "valid", "test"]
    _close_epochs([(k, v) for k, v in js0["epochs"][:3]] + log,
                  runs["one"][0], "tp2 then tp1 vs one process")
    _close_params(params, one, "tp2 then tp1 vs one process")

    opt = parse_arguments(_argv(root, tod_checkpoint, tmp / "tp2"))
    memory = cli.resolve_memory(opt)
    tok = load_tokenizer(None, tod_checkpoint, memory,
                         require_pretrained=True)
    cfg, _ = tloop.build_model(opt, memory, tok, "cpu")
    pred = load_predictor(exp, memory, cfg, tok, device="cpu",
                          layout="tod", use_segments=True)
    best = torch.load(os.path.join(exp, "model.ckpt"), weights_only=True)
    for k, v in flat(best["params"]).items():
        assert torch.equal(flat(pred.params)[k].cpu(), v), k
    utts = [" ".join(a) for a in read_sep_data(
        os.path.join(root, "valid")).asr_seqs]
    assert len(pred.predict(utts)) == len(utts)
