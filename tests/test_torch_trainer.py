"""The port's ``Trainer`` (``nbest_asr_tpu_torch/train/loop.py``) against
the JAX package's on the CPU, and its checkpoint resume.

(b) Both Trainers start from the same parameters (JAX's init, bridged
with ``params_bridge.from_jax_numpy``) and the same packed splits, in f32
at dropout 0, two layers of width 64, and run ``train()`` for two epochs
on four epoch plans: the parity batch; ``length_buckets`` with a
``token_budget``; ``pack_examples``; and ``steps_per_call=2`` (JAX runs
chains of two steps as one compiled call, the port the same plan's steps
in order).  Per epoch, the train mean loss / P / R / F1 / Acc and the
valid and test metrics agree within 1e-4 relative (the two frameworks
sum in different orders); the dumps, the classification reports and
``best.json`` agree exactly.  JAX runs on a one-device mesh.

(c) A run stopped after epoch 0 (as SIGTERM would stop it) and resumed
from its checkpoint in a fresh Trainer ends bit-identical to an
uninterrupted run -- params, optimizer state, step and ``best.json`` --
with dropout 0.1, which makes the resumed run depend on the restored
dropout generator and shuffle state."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from nbest_asr_tpu.config import RunOptions as JRunOptions
from nbest_asr_tpu.data.dataset import RawSplit as JRawSplit
from nbest_asr_tpu.data.input_builder import pack_split as j_pack_split
from nbest_asr_tpu.data.tokenizer import WordVocabTokenizer as JTokenizer
from nbest_asr_tpu.models.encoder import EncoderConfig as JEncoderConfig
from nbest_asr_tpu.models.model import ModelConfig as JModelConfig
from nbest_asr_tpu.models.model import init_model_params as j_init
from nbest_asr_tpu.parallel.mesh import make_mesh
from nbest_asr_tpu.train.loop import Trainer as JTrainer
from nbest_asr_tpu_torch.config import RunOptions
from nbest_asr_tpu_torch.data.dataset import RawSplit
from nbest_asr_tpu_torch.data.input_builder import pack_split
from nbest_asr_tpu_torch.data.tokenizer import WordVocabTokenizer
from nbest_asr_tpu_torch.data.vocab import Memory
from nbest_asr_tpu_torch.models.encoder import EncoderConfig
from nbest_asr_tpu_torch.models.model import ModelConfig, init_model_params
from nbest_asr_tpu_torch.params_bridge import from_jax_numpy
from nbest_asr_tpu_torch.train.loop import Trainer

SIZES = {"train": 56, "valid": 20, "test": 16}
ENC = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
           max_position=128, compute_dtype="float32", hidden_dropout=0.0,
           attn_dropout=0.0)
PLANS = {
    "parity": dict(),
    "buckets_budget": dict(length_buckets="16,32,48", token_budget=256),
    "packed": dict(pack_examples=True, pack_capacity=48, pack_max_segs=4),
    "steps_per_call": dict(steps_per_call=2),
}


def _raw_splits(memory, seed=0):
    """DSTC2-shaped rows of 6-40 words with 0-2 gold labels (an OOV one
    now and then)."""
    rng = np.random.RandomState(seed)
    words = [w for w in memory.word2idx if w.isalpha()]
    labels = [memory.idx2label[i] for i in range(2, memory.n_bottom)]
    out = {}
    for name, n in SIZES.items():
        asr, lab = [], []
        for _ in range(n):
            usr = list(rng.choice(words, rng.randint(3, 36)))
            asr.append(["[CLS]", "[SYS]", *rng.choice(words, 3), "[USR]",
                        *usr])
            gold = list(rng.choice(labels, rng.randint(0, 3),
                                   replace=False))
            if rng.rand() < 0.05:
                gold.append("inform-food-unseen")
            lab.append(gold)
        out[name] = (asr, lab)
    return out


@pytest.fixture(scope="module")
def setup(tiny_memory):
    tmem = Memory.from_json(tiny_memory.to_json())
    raw = _raw_splits(tiny_memory)
    jtok, ttok = JTokenizer(tiny_memory), WordVocabTokenizer(tmem)
    jpacked = {k: j_pack_split(JRawSplit(a, a, l), jtok, tiny_memory,
                               max_len=48) for k, (a, l) in raw.items()}
    tpacked = {k: pack_split(RawSplit(a, a, l), ttok, tmem, max_len=48)
               for k, (a, l) in raw.items()}
    return tiny_memory, tmem, jtok.vocab_size, jpacked, tpacked


def _record(trainer):
    """Wrap the trainer's epoch functions to log what they return."""
    log = []
    run_train, run_eval = trainer.run_train_epoch, trainer.run_eval_epoch

    def train_epoch():
        m = run_train()
        log.append(("train", m))
        return m

    def eval_epoch(split, *a, **kw):
        m, info = run_eval(split, *a, **kw)
        log.append((split, m))
        return m, info

    trainer.run_train_epoch, trainer.run_eval_epoch = train_epoch, eval_epoch
    return log


def _metrics(m):
    return [m.mean_loss, m.precision, m.recall, m.f1, m.acc]


@pytest.mark.parametrize("plan", list(PLANS))
def test_trainer_matches_jax(setup, tmp_path, plan):
    jmem, tmem, vocab, jpacked, tpacked = setup
    kw = dict(dataset="dstc2", dataroot="unused", batchSize=8, max_epoch=2,
              random_seed=7, lr=1e-3, bert_lr=1e-3, bert_dropout=0.0,
              **PLANS[plan])
    jopt = JRunOptions(experiment=str(tmp_path / "j"), **kw)
    jopt.exp_dir = str(tmp_path / "j")
    topt = RunOptions(experiment=str(tmp_path / "t"), **kw)
    topt.exp_dir = str(tmp_path / "t")
    jcfg = JModelConfig(encoder=JEncoderConfig(vocab_size=vocab, **ENC),
                        n_top=jmem.n_top, n_bottom=jmem.n_bottom)
    tcfg = ModelConfig(encoder=EncoderConfig(vocab_size=vocab, **ENC),
                       n_top=tmem.n_top, n_bottom=tmem.n_bottom)
    params = jax.device_get(j_init(jax.random.PRNGKey(3), jcfg))

    jt = JTrainer(jopt, jmem, jcfg, jax.tree.map(np.array, params),
                  jpacked, mesh=make_mesh(n_data=1,
                                          devices=jax.devices()[:1]))
    tt = Trainer(topt, tmem, tcfg, from_jax_numpy(params), tpacked,
                 device="cpu")
    assert tt.opt_cfg.t_total == jt.opt_cfg.t_total
    jlog, tlog = _record(jt), _record(tt)
    jbest, tbest = jt.train(), tt.train()

    assert [k for k, _ in tlog] == [k for k, _ in jlog] == [
        "train", "valid", "test"] * 2
    for (split, tm), (_, jm) in zip(tlog, jlog):
        np.testing.assert_allclose(_metrics(tm), _metrics(jm), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{plan} {split}")
    assert tbest == jbest
    assert int(tt.state.step) == int(jt.state.step)
    names = ["best.json"] + [
        f"{pre}{split}{suf}" for split in ("valid", "test")
        for pre, suf in ((f"", ".iter0"), ("", ".iter1"),
                         ("", ".iter0.err"), ("", ".iter1.err"))] + [
        f"classification_report_epoch_{i}_for_{s}.txt"
        for i in (0, 1) for s in ("valid", "test")]
    for name in names:
        with open(os.path.join(topt.exp_dir, name)) as a, \
                open(os.path.join(jopt.exp_dir, name)) as b:
            assert a.read() == b.read(), name


def _port_trainer(setup, exp_dir, **kw):
    _, tmem, vocab, _, tpacked = setup
    opt = RunOptions(dataset="dstc2", dataroot="unused", batchSize=8,
                     max_epoch=3, random_seed=5, lr=1e-3, bert_lr=1e-3,
                     dropout=0.1, experiment=str(exp_dir),
                     length_buckets="24,48", **kw)
    opt.exp_dir = str(exp_dir)
    enc = dict(ENC, hidden_dropout=0.1, attn_dropout=0.1)
    cfg = ModelConfig(encoder=EncoderConfig(vocab_size=vocab, **enc),
                      n_top=tmem.n_top, n_bottom=tmem.n_bottom,
                      head_dropout=0.1)
    params = init_model_params(torch.Generator().manual_seed(1), cfg)
    return Trainer(opt, tmem, cfg, params, tpacked, device="cpu")


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_resume_is_bit_identical_with_dropout(setup, tmp_path):
    whole = _port_trainer(setup, tmp_path / "a")
    best_a = whole.train()

    stopped = _port_trainer(setup, tmp_path / "b")
    stopped.train(stop_after_epoch=0)
    ckpt = tmp_path / "b" / "ckpt_epoch0"
    assert ckpt.exists() and (tmp_path / "b" / "ckpt_epoch0.meta.json"
                              ).exists()
    resumed = _port_trainer(setup, tmp_path / "b")
    resumed.load_checkpoint(str(ckpt))
    assert resumed._start_epoch == 1
    best_b = resumed.train()

    assert best_a == best_b
    assert resumed.state.step == whole.state.step > 0
    _assert_trees_equal(resumed.state.params, whole.state.params)
    _assert_trees_equal(resumed.state.opt_state._asdict(),
                        whole.state.opt_state._asdict())
    for d in ("a", "b"):
        with open(tmp_path / d / "best.json") as fp:
            assert json.load(fp) == best_a
