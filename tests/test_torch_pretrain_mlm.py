"""The port's MLM pretraining tool (``nbest_asr_tpu_torch/tools/
pretrain_mlm.py``) against the JAX package's ``tools/pretrain_mlm.py`` on
the CPU: ``corpus_lines`` and ``pack_mlm_pool`` equal JAX's functions (on
one vocabulary directory, read by the port's ``WordPieceTokenizer`` and by
JAX's ``transformers`` adapter), the batch sizes and 50 steps of the bucket
and row schedule equal JAX's formulas (``tools/pretrain_mlm.py:269-292``)
for the same seed; a run at ``--platform cpu`` lowers the MLM loss, its
export reads back through both packages' ``load_pretrained_encoder`` to
the same arrays, and ``cli.main --tod_pre_trained_model --require_pretrained``
fine-tunes from it.  Tolerance: none (equal arrays and sequences)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from chip_smoke import write_dstc2_sessions
from nbest_asr_tpu.data.dataset import read_sep_data as j_read
from nbest_asr_tpu.data.tokenizer import HFTokenizerAdapter
from nbest_asr_tpu_torch import cli
from nbest_asr_tpu_torch.data.dataset import read_sep_data
from nbest_asr_tpu_torch.data.etl import run_etl
from nbest_asr_tpu_torch.data.tokenizer import WordPieceTokenizer
from nbest_asr_tpu_torch.tools import pretrain_mlm as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--platform", "cpu", "--hidden", "64", "--n_layers", "2",
        "--n_heads", "4", "--intermediate", "128", "--vocab_size", "512",
        "--steps", "20", "--lr", "1e-3", "--log_every", "5",
        "--buckets", "64,96", "--token_budget", "2048"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_pretrain_mlm", os.path.join(REPO, "tools", "pretrain_mlm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    """The port's ETL over 40 synthetic DSTC2 sessions."""
    d = tmp_path_factory.mktemp("mlm")
    write_dstc2_sessions(str(d / "dstc2"), 40, seed=5)
    run_etl(str(d / "dstc2"), str(d / "out"))
    return str(d / "out" / "processed_data" / "raw")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module's tiny runs: the tests share the
    CPU with others, where several threads each slow every run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pretrained(dataroot, tmp_path_factory):
    """One in-process run of the tool at the tiny width -> (its result,
    its output directory)."""
    out = str(tmp_path_factory.mktemp("ckpt"))
    res = tool.run(tool.parse_args(TINY + ["--dataroot", dataroot,
                                           "--out", out]))
    return res, out


def test_corpus_and_pool_equal_jax(dataroot, tmp_path):
    jt = _jax_tool()
    path = os.path.join(dataroot, "train")
    raw, jraw = read_sep_data(path), j_read(path)
    lines = tool.corpus_lines(raw)
    assert lines == jt.corpus_lines(jraw) and len(lines) == 2 * len(raw)
    tool.train_wordpiece_vocab(lines, str(tmp_path), 512)
    tok, jtok = WordPieceTokenizer(str(tmp_path)), \
        HFTokenizerAdapter(str(tmp_path))
    special = tok.convert_tokens_to_ids(tool.SPECIAL_TOKENS)
    assert special == jtok.convert_tokens_to_ids(tool.SPECIAL_TOKENS)
    for buckets in ([64, 96], [32]):
        pool, dropped = tool.pack_mlm_pool(raw, tok, buckets, special)
        jpool, jdropped = jt.pack_mlm_pool(jraw, jtok, buckets, special)
        assert dropped == jdropped and sorted(pool) == sorted(jpool)
        for b in jpool:
            for k, v in jpool[b].items():
                np.testing.assert_array_equal(pool[b][k], v,
                                              err_msg=f"{b} {k}")
    assert dropped > 0 and sum(v["input_ids"].shape[0]
                               for v in pool.values()) > 0


def _jax_schedule(pool, token_budget, seed, steps):
    """``tools/pretrain_mlm.py:269-292`` as written there."""
    host_rng = np.random.default_rng(seed)
    batch_of = {}
    for b, arrs in pool.items():
        n = arrs["input_ids"].shape[0]
        batch_of[b] = min(max(token_budget // b, 8), n)
    bucket_ids = sorted(pool)
    bucket_p = np.array([pool[b]["input_ids"].shape[0] * b
                         for b in bucket_ids], dtype=np.float64)
    bucket_p /= bucket_p.sum()
    cursors = {b: None for b in pool}

    def next_batch(b):
        n = pool[b]["input_ids"].shape[0]
        bs = batch_of[b]
        if cursors[b] is None or cursors[b][1] + bs > n:
            cursors[b] = (host_rng.permutation(n), 0)
        perm, pos = cursors[b]
        idx = perm[pos:pos + bs]
        cursors[b] = (perm, pos + bs)
        return idx

    out = []
    for _ in range(steps):
        b = bucket_ids[host_rng.choice(len(bucket_ids), p=bucket_p)]
        out.append((b, next_batch(b)))
    return batch_of, out


@pytest.mark.parametrize("budget,seed", [(8192, 42), (1024, 7)])
def test_batch_sizes_and_schedule_equal_jax(budget, seed):
    """Three buckets, one smaller than its batch: 50 steps' buckets and
    rows, permutations renewed as JAX renews them."""
    pool = {b: {"input_ids": np.zeros((n, b), np.int32)}
            for b, n in ((64, 300), (96, 90), (288, 5))}
    want_sizes, want = _jax_schedule(pool, budget, seed, 50)
    sizes = tool.batch_sizes(pool, budget)
    assert sizes == want_sizes
    plan = tool.schedule(pool, sizes, seed)
    got = [next(plan) for _ in range(50)]
    assert [b for b, _ in got] == [b for b, _ in want]
    for (_, i), (_, j) in zip(got, want):
        np.testing.assert_array_equal(i, j)
    assert len({b for b, _ in got}) == 3


def test_pretraining_lowers_the_loss_and_exports(pretrained, dataroot):
    """20 steps at lr 1e-3 of 32- and 21-row batches: the last five steps'
    mean loss below the first's by more than 0.1; the files and
    ``pretrain_meta.json``'s keys of JAX's tool; the export read back by
    JAX's and the port's ``load_pretrained_encoder`` to the same arrays."""
    import json

    import jax

    from nbest_asr_tpu.models import hf_convert as jhf
    from nbest_asr_tpu_torch.models import hf_convert as thf

    res, out = pretrained
    losses = res["losses"]
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < losses[0] - 0.1
    assert res["step_ms"] is None
    assert {"vocab.txt", "tokenizer_config.json", "special_tokens_map.json",
            "config.json", "pretrain_meta.json"} <= set(os.listdir(out))
    with open(os.path.join(out, "pretrain_meta.json")) as fp:
        meta = json.load(fp)
    assert sorted(meta) == sorted([
        "steps", "lr", "vocab_size", "buckets", "batch_sizes", "seed",
        "mask_rate", "wall_s", "corpus_utterances", "final_loss",
        "loss_curve"])
    assert meta["vocab_size"] % 128 == 0 and meta["steps"] == 20
    assert [c["step"] for c in meta["loss_curve"]] == [5, 10, 15, 20]
    tcfg, tenc = thf.load_pretrained_encoder(out)
    jcfg, jenc = jhf.load_pretrained_encoder(out)
    assert tcfg.vocab_size == jcfg.vocab_size == meta["vocab_size"]
    assert (tcfg.num_layers, tcfg.hidden_size) == (2, 64)
    jenc = jax.device_get(jenc)

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert a.keys() == b.keys(), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=path)

    walk(tenc, jenc)


def test_cli_fine_tunes_from_the_export(pretrained, dataroot, tmp_path,
                                        capsys):
    """``--tod_pre_trained_model <export> --require_pretrained``: one
    epoch, no warning, the encoder the export's."""
    _, out = pretrained
    argv = ["--dataset", "dstc2", "--dataroot", dataroot,
            "--tod_pre_trained_model", out, "--require_pretrained",
            "--batchSize", "8", "--max_epoch", "1", "--experiment",
            str(tmp_path / "exp"), "--eval_artifacts", "none"]
    assert cli.main(argv, device="cpu") == 0
    err = capsys.readouterr().err
    assert "WARNING" not in err and "error" not in err
    (run_dir,) = [d for d, _, fs in os.walk(tmp_path / "exp")
                  if "log.train" in fs]
    with open(os.path.join(run_dir, "log.train")) as fp:
        log = fp.read()
    assert "[Train]" in log and "BEST RESULT" in log


def test_refusals(dataroot, tmp_path, capsys, monkeypatch):
    """No ``--dataroot``: return code 2; no ``--platform cpu`` and no CUDA:
    the tool raises rather than run on the CPU."""
    assert tool.main(["--platform", "cpu", "--out", str(tmp_path)]) == 2
    assert "--dataroot" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for platform in ([], ["--platform", "gpu"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(platform + ["--dataroot", dataroot, "--out",
                                  str(tmp_path)])
