"""The port's CLI (``nbest_asr_tpu_torch/cli.py``) and the copies it reads,
against the JAX package's on the CPU.

(a) The copies: ``RunOptions``' defaults and ``parse_arguments`` on a set
of command lines (every field equal), ``get_exp_dir``, ``read_sep_data``
and the coverage sample (numpy's ``RandomState(42)`` picks the rows
pandas' ``sample(random_state=42)`` picks), the observability CSV byte for
byte and the classification report (the same text, so the same numbers).
(d) Both CLIs, at ``--n_layers 2 --n_head 4`` on a synthetic dataroot
(the port with ``device="cpu"``), write the same set of artifacts, and
their log lines have the same formats; the error cases of the JAX CLI's
tests return the same codes.  (e) ``--testing`` reloads ``model.ckpt`` and
reproduces the best epoch's valid metrics.  (f) A world size that
``--n_model_parallel`` does not divide returns 2 with its message; the
pretrained flags are honoured: with no local checkpoint both CLIs warn
alike and train, or under ``--require_pretrained`` return 2 with the same
message, and a tiny ``--tod_pre_trained_model`` run matches JAX's epoch by
epoch, with ``--remat`` too; the splits the native packer gives equal the
Python packer's (``--no_native_loader``) and JAX's CLI's.  (g)
``load_predictor`` restores a Trainer's params and predicts as a Predictor
built on them."""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

from nbest_asr_tpu import cli as jcli
from nbest_asr_tpu.config import RunOptions as JRunOptions
from nbest_asr_tpu.config import parse_arguments as j_parse
from nbest_asr_tpu.data.dataset import RawSplit as JRawSplit
from nbest_asr_tpu.data.dataset import read_sep_data as j_read
from nbest_asr_tpu.data.dataset import \
    stratified_coverage_sample as j_coverage
from nbest_asr_tpu.utils import observability as jobs
from nbest_asr_tpu.utils.exp_dir import get_exp_dir as j_exp_dir
from nbest_asr_tpu_torch import cli
from nbest_asr_tpu_torch.config import RunOptions, parse_arguments
from nbest_asr_tpu_torch.data.dataset import (RawSplit, read_sep_data,
                                              stratified_coverage_sample)
from nbest_asr_tpu_torch.utils import observability as tobs
from nbest_asr_tpu_torch.utils.exp_dir import get_exp_dir


def _write_dataroot(root, memory, sizes=(40, 16, 16), seed=0):
    """memory.json and train / valid / test shards in the ``asr \\t<=>\\t
    trans \\t<=>\\t labels`` format, from a seed; one label is gold in
    most rows, so that one epoch learns to predict it (F1 above 0)."""
    root.mkdir(parents=True, exist_ok=True)
    memory.save(str(root / "memory.json"))
    rng = np.random.RandomState(seed)
    words = [w for w in memory.word2idx if w.isalpha()]
    labels = [memory.idx2label[i] for i in range(2, memory.n_bottom)]
    for name, n in zip(("train", "valid", "test"), sizes):
        with open(root / name, "w") as fp:
            for _ in range(n):
                asr = ["[CLS]", "[SYS]", *rng.choice(words, 3), "[USR]",
                       *rng.choice(words, rng.randint(3, 20))]
                gold = list(rng.choice(labels[1:], rng.randint(0, 2),
                                       replace=False))
                if rng.rand() < 0.8:
                    gold.insert(0, labels[0])
                fp.write("%s\t<=>\t%s\t<=>\t%s\n" % (
                    " ".join(asr), " ".join(asr), ";".join(gold)))
    return str(root)


@pytest.fixture(scope="module")
def dataroot(tiny_memory, tmp_path_factory):
    return _write_dataroot(tmp_path_factory.mktemp("cli") / "dataroot",
                           tiny_memory)


ARGVS = [
    [],
    ["--n_layers", "12", "--batchSize", "32", "--compute_dtype", "bfloat16",
     "--length_buckets", "64,96", "--token_budget", "8192",
     "--no_fused_attn", "--int8_train", "--no_int8_train_bwd",
     "--coverage", "0.3", "--add_segment_ids", "--eval_every", "2",
     "--flash_min_seq", "96", "--no_native_loader", "--resume", "auto"],
    ["--pack_examples", "--pack_capacity", "128", "--steps_per_call", "3",
     "--optim_choice", "adamw", "--fix_bert_model", "--without_system_act",
     "--eval_artifacts", "none", "--save_best", "none", "--testing",
     "--use_flash_attention", "--use_fused_ffn", "--deviceId", "2"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "train", "flags"])
def test_config_copy_matches_jax(argv, tmp_path):
    base = ["--dataset", "dstc2", "--dataroot", str(tmp_path),
            "--experiment", str(tmp_path / "exp")]
    got, want = parse_arguments(base + argv), j_parse(base + argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("n_accum_steps", "micro_batch", "layout"):
        assert getattr(got, prop) == getattr(want, prop)
    assert get_exp_dir(got) == j_exp_dir(want)
    assert dataclasses.asdict(RunOptions()) == dataclasses.asdict(
        JRunOptions())


@pytest.mark.parametrize("coverage", [None, 0.05, 0.2, 0.5, 0.9, 1.0])
def test_read_sep_data_and_coverage_sample(dataroot, coverage):
    path = os.path.join(dataroot, "train")
    got, want = read_sep_data(path, coverage), j_read(path, coverage)
    assert (got.asr_seqs, got.trans_seqs, got.labels) == (
        want.asr_seqs, want.trans_seqs, want.labels)
    # a larger split with repeated label sets: the sampled rows and order
    rng = np.random.RandomState(4)
    labels = [[f"l{rng.randint(9)}"] * rng.randint(0, 2) for _ in range(500)]
    rows = [[str(i)] for i in range(500)]
    if coverage:
        assert stratified_coverage_sample(
            RawSplit(rows, rows, labels), coverage).asr_seqs == j_coverage(
            JRawSplit(rows, rows, labels), coverage).asr_seqs


def test_observability_copy_is_byte_equal(tmp_path):
    rng = np.random.RandomState(2)
    labels = ["inform-food-chinese", "request-phone", "a,b", 'say "x"',
              "thankyou"]
    n = 30
    golds = [list(rng.choice(labels, rng.randint(0, 3), replace=False))
             for _ in range(n)]
    preds = [list(rng.choice(labels + ["extra"], rng.randint(0, 3),
                             replace=False)) for _ in range(n)]
    raw = [" ".join(rng.choice(["i", "want,", '"x"', "food"],
                               rng.randint(1, 6))) for _ in range(n)]
    matches = [set(p) == set(g) for p, g in zip(preds, golds)]
    stats = (0.1 + 0.2, 100 / 3, 50.0, 1e-7, 0.0)
    for mod, d in ((jobs, "j"), (tobs, "t")):
        os.makedirs(tmp_path / d)
        mod.observability_lens(mod.EpochInfo(raw, preds, golds, matches,
                                             *stats), 4, "valid",
                               str(tmp_path / d), "name")
    for f in os.listdir(tmp_path / "j"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f
    assert tobs.classification_report([], []) == \
        jobs.classification_report([], [])


ARTIFACTS = {"log.train", "config.json", "best.json", "model.ckpt",
             "model.ckpt.meta.json", "valid.iter0", "valid.iter0.err",
             "test.iter0", "test.iter0.err",
             "epoch_0_for_valid_observe_tod_asr_bert_stc.csv",
             "epoch_0_for_test_observe_tod_asr_bert_stc.csv",
             "classification_report_epoch_0_for_valid.txt",
             "classification_report_epoch_0_for_test.txt"}


def _line_format(line: str) -> str:
    """A log line with its numbers and timestamp masked."""
    if line.startswith("Training starts at"):
        return "Training starts at <time>"
    return re.sub(r"\d+(\.\d+)?", "<n>", line)


def _run_dir(exp):
    (d,) = [dp for dp, _, fs in os.walk(exp) if "log.train" in fs]
    return d


@pytest.fixture(scope="module")
def cli_runs(dataroot, tmp_path_factory):
    """One epoch of each CLI (the port's on the CPU); the port's then run
    again with --testing.  JAX's CLI sets its PRNG and compile cache in
    the process-wide config: both are put back."""
    tmp = tmp_path_factory.mktemp("runs")
    args = ["--dataset", "dstc2", "--dataroot", dataroot, "--batchSize",
            "8", "--max_epoch", "1", "--n_layers", "2", "--n_head", "4",
            "--lr", "1e-3", "--bert_lr", "1e-3", "--add_segment_ids"]
    saved = {k: getattr(jax.config, k) for k in (
        "jax_default_prng_impl", "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    os.environ["NBEST_ASR_TPU_CACHE"] = str(tmp / "jax_cache")
    try:
        assert jcli.main(args + ["--experiment", str(tmp / "j")]) == 0
    finally:
        del os.environ["NBEST_ASR_TPU_CACHE"]
        for k, v in saved.items():
            jax.config.update(k, v)
    targs = args + ["--experiment", str(tmp / "t")]
    assert cli.main(targs, device="cpu") == 0
    assert cli.main(targs + ["--testing"], device="cpu") == 0
    jdir, tdir = _run_dir(tmp / "j"), _run_dir(tmp / "t")
    assert os.path.relpath(tdir, tmp / "t") == os.path.relpath(
        jdir, tmp / "j")
    return jdir, tdir


def test_cli_writes_jax_artifacts(cli_runs):
    jdir, tdir = cli_runs
    jfiles = set(os.listdir(jdir))
    assert ARTIFACTS <= jfiles
    assert ARTIFACTS <= set(os.listdir(tdir))
    with open(os.path.join(jdir, "log.train")) as a, \
            open(os.path.join(tdir, "log.train")) as b:
        assert [_line_format(x) for x in b] == [_line_format(x) for x in a]
    for name in ("valid.iter0", "test.iter0"):
        with open(os.path.join(jdir, name)) as a, \
                open(os.path.join(tdir, name)) as b:
            ja, tb = a.read().splitlines(), b.read().splitlines()
        assert [x.split("\t<=>\t")[::2] for x in tb] == \
            [x.split("\t<=>\t")[::2] for x in ja]


def test_cli_testing_reproduces_best_valid(cli_runs):
    _, tdir = cli_runs
    with open(os.path.join(tdir, "log.train")) as fp:
        train_log = fp.read()
    with open(os.path.join(tdir, "log.test")) as fp:
        test_log = fp.read()
    best = re.search(r"BEST RESULT:.*Best valid F1/Acc: ([\d.]+)/([\d.]+)",
                     train_log).groups()
    valid = re.search(r"\[Valid\].*\(p/r/f\): \([\d.]+/[\d.]+/([\d.]+)\)"
                      r"\tAcc: ([\d.]+)", test_log).groups()
    assert "NEW BEST" in train_log
    assert valid == best


def _rc_and_err(main, argv, capsys, **kw):
    try:
        rc = main(argv, **kw)
    except SystemExit as e:      # argparse
        rc = e.code
    return rc, capsys.readouterr().err


@pytest.mark.parametrize("case", ["no_memory", "no_valid", "no_train",
                                  "no_dataset"])
def test_cli_error_codes_match_jax(case, tiny_memory, tmp_path, capsys):
    root = tmp_path / "root"
    _write_dataroot(root, tiny_memory, sizes=(8, 8, 8))
    argv = ["--dataset", "dstc2", "--dataroot", str(root), "--experiment",
            str(tmp_path / "exp")]
    if case == "no_memory":
        os.remove(root / "memory.json")
    elif case == "no_valid":
        os.remove(root / "valid")
    elif case == "no_train":
        os.remove(root / "train")
    else:
        argv = argv[2:]
    saved = jax.config.jax_default_prng_impl
    try:
        want = _rc_and_err(jcli.main, argv, capsys)
    finally:
        jax.config.update("jax_default_prng_impl", saved)
    got = _rc_and_err(cli.main, argv, capsys, device="cpu")
    assert got[0] == want[0] == 2
    assert got[1].splitlines()[-1].replace("nbest_asr_tpu_torch", "") == \
        want[1].splitlines()[-1].replace("nbest_asr_tpu", "")


@pytest.mark.parametrize("world", ["1", "3"])
def test_cli_refuses_a_world_that_tp_does_not_divide(world, dataroot,
                                                      tmp_path, capsys,
                                                      monkeypatch):
    """``--n_model_parallel 2`` in a world of 1 (no torchrun) or of 3
    (torchrun's ``WORLD_SIZE``) returns 2 before any process group is
    made or anything is written."""
    monkeypatch.setenv("WORLD_SIZE", world)
    rc, err = _rc_and_err(cli.main, [
        "--dataset", "dstc2", "--dataroot", dataroot, "--experiment",
        str(tmp_path / "exp"), "--n_model_parallel", "2"], capsys,
        device="cpu")
    assert rc == 2
    assert f"--n_model_parallel 2 does not divide the world size {world}" \
        in err
    assert not (tmp_path / "exp").exists()
    assert not torch.distributed.is_initialized()


def _warnings(err: str):
    """The WARNING lines of ``err``, the detail of the encoder's load
    error masked: JAX's comes from ``transformers``, the port's from its
    own reader (``hf_convert.load_pretrained_encoder``)."""
    return [re.sub(r"(pretrained encoder '[^']*': \w+: ).*", r"\1<detail>",
                   line) for line in err.splitlines()
            if line.startswith("WARNING")]


def _jax_main(argv, capsys, tmp):
    """JAX's ``cli.main`` -> (rc, stderr), its process-wide PRNG and
    compile-cache settings put back."""
    saved = {k: getattr(jax.config, k) for k in (
        "jax_default_prng_impl", "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    os.environ["NBEST_ASR_TPU_CACHE"] = str(tmp / "jax_cache")
    try:
        return _rc_and_err(jcli.main, argv, capsys)
    finally:
        del os.environ["NBEST_ASR_TPU_CACHE"]
        for k, v in saved.items():
            jax.config.update(k, v)


@pytest.mark.parametrize("required", [False, True],
                         ids=["warns_then_trains", "require_pretrained"])
def test_cli_pretrained_without_checkpoint_as_jax(required, dataroot,
                                                  tmp_path, capsys,
                                                  monkeypatch):
    """``--pre_trained_model bert`` with no local checkpoint: JAX's CLI
    warns twice (tokenizer, encoder) and trains from scratch, or under
    ``--require_pretrained`` returns 2 with the tokenizer's error; the
    port's does the same, with the same text."""
    monkeypatch.delenv("NBEST_HF_LOCAL", raising=False)
    argv = ["--dataset", "dstc2", "--dataroot", dataroot,
            "--pre_trained_model", "bert", "--n_layers", "1", "--batchSize",
            "8", "--max_epoch", "1", "--eval_artifacts", "none",
            "--save_best", "none"] + (["--require_pretrained"]
                                      if required else [])
    want = _jax_main(argv + ["--experiment", str(tmp_path / "j")], capsys,
                     tmp_path)
    got = _rc_and_err(cli.main, argv + ["--experiment", str(tmp_path / "t")],
                      capsys, device="cpu")
    assert got[0] == want[0] == (2 if required else 0)
    if required:
        assert got[1] == want[1]
        assert "--require_pretrained set" in got[1]
        assert not (tmp_path / "t").exists()
        return
    assert _warnings(got[1]) == _warnings(want[1])
    assert len(_warnings(got[1])) == 4
    assert "pretrained encoder 'bert-base-uncased': OSError" in got[1]
    logs = [open(os.path.join(_run_dir(tmp_path / d), "log.train")).read()
            for d in ("j", "t")]
    assert all("[Train]" in log and "BEST RESULT" in log for log in logs)


BERT_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


@pytest.fixture(scope="module")
def tod_checkpoint(tiny_memory, tmp_path_factory):
    """A tiny BERT checkpoint directory as ``--tod_pre_trained_model``
    takes it: ``BertModel.save_pretrained`` (model.safetensors) and
    ``BertTokenizer.save_pretrained`` with ``[SYS]`` / ``[USR]`` added past
    ``vocab.txt`` (and so past the word table, where both packages clamp
    the ids)."""
    from transformers import BertConfig, BertModel, BertTokenizer

    d = tmp_path_factory.mktemp("tod_ckpt")
    words = sorted(w for w in tiny_memory.word2idx if w.isalpha())
    (d / "vocab.txt").write_text("\n".join(BERT_VOCAB + words) + "\n")
    tok = BertTokenizer(str(d / "vocab.txt"))
    tok.add_special_tokens({"additional_special_tokens": ["[SYS]", "[USR]"]})
    tok.save_pretrained(str(d))
    torch.manual_seed(11)
    model = BertModel(BertConfig(
        vocab_size=len(BERT_VOCAB) + len(words), hidden_size=32,
        num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=128), add_pooling_layer=False)
    model.save_pretrained(str(d))
    return str(d)


def _record_epochs(monkeypatch, trainer_cls, log):
    run_train, run_eval = trainer_cls.run_train_epoch, \
        trainer_cls.run_eval_epoch

    def train_epoch(self):
        m = run_train(self)
        log.append(("train", m))
        return m

    def eval_epoch(self, split, *a, **kw):
        m, info = run_eval(self, split, *a, **kw)
        log.append((split, m))
        return m, info

    monkeypatch.setattr(trainer_cls, "run_train_epoch", train_epoch)
    monkeypatch.setattr(trainer_cls, "run_eval_epoch", eval_epoch)


def _tod_runs(tod_checkpoint, dataroot, tmp_path, capsys, monkeypatch,
              extra=()):
    """Both CLIs, two epochs from ``tod_checkpoint`` at dropout 0 with the
    head JAX draws bridged into the port; every epoch's train / valid /
    test loss, P, R, F1 and Acc within 1e-4 relative.  -> the port's
    argv."""
    from nbest_asr_tpu.models import heads as jheads
    from nbest_asr_tpu.train import loop as jloop
    from nbest_asr_tpu_torch.params_bridge import from_jax_numpy
    from nbest_asr_tpu_torch.train import loop as tloop

    seed = 5
    argv = ["--dataset", "dstc2", "--dataroot", dataroot,
            "--tod_pre_trained_model", tod_checkpoint,
            "--require_pretrained", "--batchSize", "8", "--max_epoch", "2",
            "--lr", "1e-3", "--bert_lr", "1e-3", "--bert_dropout", "0",
            "--dropout", "0", "--random_seed", str(seed),
            "--add_segment_ids", *extra]

    def jax_head(gen, hidden, n_top, n_bottom):
        # JAX's build_model draws under the CLI's --prng_impl (rbg)
        saved = jax.config.jax_default_prng_impl
        jax.config.update("jax_default_prng_impl", "rbg")
        try:
            _, k_head = jax.random.split(jax.random.PRNGKey(seed))
            head = jheads.init_head_params(k_head, hidden, n_top, n_bottom)
            return from_jax_numpy(jax.device_get(head))
        finally:
            jax.config.update("jax_default_prng_impl", saved)

    monkeypatch.setattr(tloop, "init_head_params", jax_head)
    jlog, tlog = [], []
    _record_epochs(monkeypatch, jloop.Trainer, jlog)
    _record_epochs(monkeypatch, tloop.Trainer, tlog)
    assert _jax_main(argv + ["--experiment", str(tmp_path / "j")], capsys,
                     tmp_path)[0] == 0
    targv = argv + ["--experiment", str(tmp_path / "t")]
    assert cli.main(targv, device="cpu") == 0
    assert "WARNING" not in capsys.readouterr().err
    assert [k for k, _ in tlog] == [k for k, _ in jlog] == [
        "train", "valid", "test"] * 2
    for (split, tm), (_, jm) in zip(tlog, jlog):
        got = [tm.mean_loss, tm.precision, tm.recall, tm.f1, tm.acc]
        want = [jm.mean_loss, jm.precision, jm.recall, jm.f1, jm.acc]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=split)
    return targv


def test_cli_tod_pretrained_run_matches_jax(tod_checkpoint, dataroot,
                                            tmp_path, capsys, monkeypatch):
    """``--tod_pre_trained_model DIR --require_pretrained``, two epochs at
    dropout 0: the port's CLI (``WordPieceTokenizer``, its own checkpoint
    reader) and JAX's (``AutoTokenizer``, ``AutoModel``) start from the
    checkpoint's encoder and, with the head JAX draws (bridged in), agree
    on every epoch's train / valid / test loss, P, R, F1 and Acc within
    1e-4 relative; the port's encoder at init is the checkpoint's, and
    ``load_predictor`` serves its best checkpoint with its tokenizer."""
    from nbest_asr_tpu_torch.data.tokenizer import (WordPieceTokenizer,
                                                    load_tokenizer)
    from nbest_asr_tpu_torch.models.hf_convert import load_pretrained_encoder
    from nbest_asr_tpu_torch.serve import load_predictor
    from nbest_asr_tpu_torch.train import loop as tloop

    targv = _tod_runs(tod_checkpoint, dataroot, tmp_path, capsys,
                      monkeypatch)
    opt = parse_arguments(targv)
    memory = cli.resolve_memory(opt)
    tok = load_tokenizer(None, tod_checkpoint, memory,
                         require_pretrained=True)
    assert isinstance(tok, WordPieceTokenizer)
    cfg, params = tloop.build_model(opt, memory, tok, "cpu")
    _, enc = load_pretrained_encoder(tod_checkpoint)
    for k in enc["embeddings"]:
        assert torch.equal(params["encoder"]["embeddings"][k],
                           enc["embeddings"][k])
    assert cfg.encoder.vocab_size == tok.vocab_size < len(tok)
    pred = load_predictor(_run_dir(tmp_path / "t"), memory, cfg, tok,
                          device="cpu", layout="tod", use_segments=True)
    utts = [" ".join(a) for a in read_sep_data(
        os.path.join(dataroot, "valid")).asr_seqs]
    assert len(pred.predict(utts)) == len(utts)


def test_cli_remat_run_matches_jax(tod_checkpoint, dataroot, tmp_path,
                                   capsys, monkeypatch):
    """``--remat`` in both CLIs (JAX's ``jax.checkpoint`` over its layer
    scan, the port's ``torch.utils.checkpoint`` over each layer): the
    same two epochs as without it, within 1e-4 relative of JAX's."""
    _tod_runs(tod_checkpoint, dataroot, tmp_path, capsys, monkeypatch,
              extra=["--remat"])


def _packed_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for name in want:
        g, w = got[name], want[name]
        assert g.max_len == w.max_len, (what, name)
        for k in ("input_ids", "segment_ids", "attn_mask", "trans_input_ids",
                  "trans_segment_ids", "trans_attn_mask", "labels"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k),
                                          err_msg=f"{what} {name} {k}")
        assert g.raw_asr == w.raw_asr and g.raw_labels == w.raw_labels


@pytest.mark.parametrize("case", ["word", "wordpiece", "coverage"])
def test_cli_native_splits_equal_python_and_jax(case, dataroot,
                                                tod_checkpoint, tmp_path,
                                                monkeypatch):
    """``prepare_packed_splits`` on the native packer (the default) and
    with ``--no_native_loader``: the word-vocab tokenizer, a WordPiece
    checkpoint's (TOD layout) and a coverage sample (its temporary shard
    removed afterwards) give equal splits, equal to JAX's CLI's on its own
    native packer.  Where g++ is missing only the Python packer runs."""
    import tempfile

    from nbest_asr_tpu.data.tokenizer import load_tokenizer as j_load
    from nbest_asr_tpu.data.vocab import Memory as JMemory
    from nbest_asr_tpu_torch.data.native_loader import native_available
    from nbest_asr_tpu_torch.data.tokenizer import load_tokenizer

    argv = ["--dataset", "dstc2", "--dataroot", dataroot]
    argv += {"word": [], "coverage": ["--coverage", "0.5"],
             "wordpiece": ["--tod_pre_trained_model", tod_checkpoint]}[case]
    opt = parse_arguments(argv)
    memory = cli.resolve_memory(opt)
    tok = load_tokenizer(None, opt.tod_pre_trained_model, memory)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    packed = []
    pack = cli.pack_file_native

    def counted(path, *a, **kw):
        packed.append(path)
        return pack(path, *a, **kw)

    monkeypatch.setattr(cli, "pack_file_native", counted)
    native = cli.prepare_packed_splits(opt, memory, tok)
    assert os.listdir(tmp_path) == []
    assert bool(packed) == native_available()
    python = cli.prepare_packed_splits(
        parse_arguments(argv + ["--no_native_loader"]), memory, tok)
    _packed_equal(native, python, "native against --no_native_loader")
    jopt = j_parse(argv)
    jmem = JMemory.load(os.path.join(dataroot, "memory.json"))
    want = jcli.prepare_packed_splits(
        jopt, jmem, j_load(None, jopt.tod_pre_trained_model, jmem))
    _packed_equal(native, want, "against JAX's")
    if case == "coverage":
        assert 0 < len(native["train"].raw_asr) < 40


def test_cli_needs_cuda_or_an_explicit_device(dataroot, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--dataset", "dstc2", "--dataroot", dataroot,
                  "--experiment", str(tmp_path / "exp")])


def test_load_predictor_round_trips_params(tiny_memory, tmp_path):
    from nbest_asr_tpu_torch.data.input_builder import pack_split
    from nbest_asr_tpu_torch.data.tokenizer import WordVocabTokenizer
    from nbest_asr_tpu_torch.data.vocab import Memory
    from nbest_asr_tpu_torch.models.encoder import EncoderConfig
    from nbest_asr_tpu_torch.models.model import (ModelConfig,
                                                  init_model_params)
    from nbest_asr_tpu_torch.serve import Predictor, load_predictor
    from nbest_asr_tpu_torch.train.loop import Trainer

    memory = Memory.from_json(tiny_memory.to_json())
    root = _write_dataroot(tmp_path / "root", tiny_memory, sizes=(16, 8, 0))
    tok = WordVocabTokenizer(memory)
    packed = {s: pack_split(read_sep_data(os.path.join(root, s)), tok,
                            memory, max_len=32) for s in ("train", "valid")}
    cfg = ModelConfig(encoder=EncoderConfig(
        vocab_size=tok.vocab_size, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=128, max_position=64, hidden_dropout=0.0,
        attn_dropout=0.0), n_top=memory.n_top, n_bottom=memory.n_bottom)
    opt = RunOptions(dataset="dstc2", dataroot=root, batchSize=8,
                     max_epoch=1, experiment=str(tmp_path / "exp"))
    opt.exp_dir = str(tmp_path / "exp")
    trainer = Trainer(opt, memory, cfg, init_model_params(
        torch.Generator().manual_seed(0), cfg), packed, device="cpu")
    trainer.run_train_epoch()
    os.makedirs(opt.exp_dir)
    trainer.save_checkpoint(os.path.join(opt.exp_dir, "model.ckpt"))

    pred = load_predictor(opt.exp_dir, memory, cfg, tok, device="cpu")
    flat = jax.tree_util.tree_leaves
    for a, b in zip(flat(pred.params), flat(trainer.state.params)):
        assert torch.equal(a, b)
    utts = [" ".join(a) for a in read_sep_data(
        os.path.join(root, "valid")).asr_seqs]
    assert pred.predict(utts) == Predictor(
        trainer.state.params, cfg, memory, tok, device="cpu").predict(utts)
