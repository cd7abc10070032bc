"""The port's loss, metrics and optimizers against the JAX package's on
the fixtures of ``tests/test_train_stack.py``: ``total_loss`` (padding
rows, the MSE term, saturated probabilities with finite gradients; parts
within 1e-5 relative), the F1 counters and host metrics exactly, and
BertAdam over five updates (q/k/v-thirds clip, warmup-linear schedule,
``freeze_encoder``) within 1e-6 relative, also from a bridged mid-run
state; adam and adamw one update each."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbest_asr_tpu.models.heads import group_softmax as j_group_softmax
from nbest_asr_tpu.models.heads import hierarchy_device_arrays as j_hier
from nbest_asr_tpu.train import losses as jl
from nbest_asr_tpu.train import metrics as jm
from nbest_asr_tpu.train import optimizer as jo
from nbest_asr_tpu_torch.models.heads import hierarchy_device_arrays
from nbest_asr_tpu_torch.params_bridge import (from_jax_numpy,
                                               opt_state_from_numpy,
                                               opt_state_to_numpy, to_numpy)
from nbest_asr_tpu_torch.train import losses as tl
from nbest_asr_tpu_torch.train import metrics as tm
from nbest_asr_tpu_torch.train import optimizer as to


@pytest.fixture()
def setup(tiny_memory):
    """The fixture of tests/test_train_stack.py, plus the group softmax
    and final scores it implies."""
    mem = tiny_memory
    arr = mem.arrays()
    rng = np.random.RandomState(3)
    b = 6
    logits = rng.randn(b, mem.n_bottom).astype(np.float32)
    labels = np.zeros((b, mem.n_bottom), np.float32)
    for i, lbls in enumerate([["inform-food-chinese"],
                              ["negate", "request-phone"],
                              ["confirm-area-north"], ["thankyou"], [],
                              ["inform-food-indian", "confirm-area-south"]]):
        for l in lbls:
            labels[i, mem.label2idx[l]] = 1.0
    top = 1 / (1 + np.exp(-rng.randn(b, mem.n_top).astype(np.float32)))
    jh = j_hier(arr)
    probs = np.asarray(j_group_softmax(jnp.asarray(logits),
                                       jh["membership"], jh["bottom2top"]))
    b2t = np.asarray(arr.bottom2top)
    final = np.where(np.asarray(arr.is_multi_top)[b2t],
                     top[:, b2t] * probs, top[:, b2t]).astype(np.float32)
    return mem, jh, hierarchy_device_arrays(arr), top, probs, final, labels


def _both(setup, cfg_l2=False, mask=None, cls=None):
    mem, jh, th, top, probs, final, labels = setup
    kw_j, kw_t = {}, {}
    if mask is not None:
        kw_j["example_mask"] = jnp.asarray(mask)
        kw_t["example_mask"] = torch.from_numpy(mask)
    if cls is not None:
        kw_j.update(asr_cls=jnp.asarray(cls[0]), trans_cls=jnp.asarray(cls[1]))
        kw_t.update(asr_cls=torch.from_numpy(cls[0]),
                    trans_cls=torch.from_numpy(cls[1]))
    _, jp = jl.total_loss(*(jnp.asarray(a) for a in (top, probs, final,
                                                     labels)), jh,
                          jl.LossConfig(add_l2_loss=cfg_l2), **kw_j)
    _, tp = tl.total_loss(*(torch.tensor(a) for a in (top, probs, final,
                                                     labels)), th,
                          tl.LossConfig(add_l2_loss=cfg_l2), **kw_t)
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_allclose(float(tp[k]), float(jp[k]), rtol=1e-5,
                                   err_msg=k)
    return tp


def test_total_loss_matches_jax(setup):
    _both(setup)


def test_total_loss_padding_rows_and_mse(setup):
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    rng = np.random.RandomState(0)
    cls = (rng.randn(6, 8).astype(np.float32),
           rng.randn(6, 8).astype(np.float32))
    parts = _both(setup, cfg_l2=True, mask=mask, cls=cls)
    assert "mse" in parts
    _both(setup, cfg_l2=True, cls=cls)


def test_loss_finite_and_matching_at_saturation(setup):
    mem, jh, th, _, _, _, labels = setup
    b2t = np.asarray(mem.arrays().bottom2top)
    top = np.zeros((labels.shape[0], mem.n_top), np.float32)
    for i in range(labels.shape[0]):
        top[i, b2t[np.nonzero(labels[i])[0]]] = 1.0
    sat = (mem, jh, th, top, labels.copy(), labels.copy(), labels)
    _both(sat)
    ts = [torch.from_numpy(a.copy()).requires_grad_(True)
          for a in (labels, top, labels)]
    total, _ = tl.total_loss(ts[1], ts[2], ts[0], torch.from_numpy(labels),
                             th, tl.LossConfig())
    total.backward()
    assert torch.isfinite(total)
    for t in ts:
        assert torch.isfinite(t.grad).all()


def test_f1_counts_and_host_metrics(setup):
    mem, *_ = setup
    rng = np.random.RandomState(1)
    pred = rng.rand(7, mem.n_bottom) > 0.7
    gold = (rng.rand(7, mem.n_bottom) > 0.7).astype(np.float32)
    gold[2] = pred[2]
    mask = np.array([1, 1, 1, 1, 1, 0, 1], np.float32)
    for m in (None, mask):
        want = jm.f1_counts_from_multihot(
            jnp.asarray(pred), jnp.asarray(gold),
            None if m is None else jnp.asarray(m))
        got = tm.f1_counts_from_multihot(
            torch.from_numpy(pred), torch.from_numpy(gold),
            None if m is None else torch.from_numpy(m))
        assert {k: float(v) for k, v in got.items()} == \
            {k: float(v) for k, v in want.items()}
    golds = [[mem.idx2label[j] for j in np.nonzero(g)[0]] + ["oov-label"]
             for g in gold]
    onto = {"informable": {"food": ["chinese", "indian"], "area": ["x"]}}
    for o in (None, onto):
        assert tm.host_eval_metrics(pred, golds, mem.idx2label, o) == \
            jm.host_eval_metrics(pred, golds, mem.idx2label, o)
    assert tm.update_f1(["a"], ["a", "a"], 0, 0, 0) == \
        jm.update_f1(["a"], ["a", "a"], 0, 0, 0)
    assert tm.compute_f1(2, 1, 1) == jm.compute_f1(2, 1, 1)


def _opt_tree(rng):
    """Leaves of every clip granularity: stacked per-layer leaves, the
    fused QKV leaf (per q/k/v third), whole head leaves; some gradients
    above the clip norm, some below."""
    def f(*shape, s=1.0):
        return (rng.randn(*shape) * s).astype(np.float32)

    params = {"encoder": {"embeddings": {"word": f(10, 8),
                                         "ln_scale": f(8)},
                          "layers": {"qkv_kernel": f(2, 8, 24),
                                     "qkv_bias": f(2, 24),
                                     "ffn_in_kernel": f(2, 8, 16)}},
              "head": {"top_kernel": f(8, 5), "top_bias": f(5)}}
    scales = {"word": 0.01, "ln_scale": 0.05, "qkv_kernel": 0.5,
              "qkv_bias": 0.02, "ffn_in_kernel": 2.0, "top_kernel": 0.1,
              "top_bias": 3.0}
    grads = [to.tree_map_with_path(
        lambda p, x: f(*x.shape, s=scales[p.split("/")[-1]]), params)
        for _ in range(5)]
    return params, grads


def _jax_run(cfg, params, grads, state=None):
    tx = jo.make_optimizer(cfg, params)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp) if state is None else state
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
    return jax.device_get(jp), state


def _port_run(cfg, params, grads, state=None):
    tp = from_jax_numpy(params)
    tx = to.make_optimizer(cfg, tp)
    state = tx.init(tp) if state is None else state
    for g in grads:
        upd, state = tx.update(from_jax_numpy(g), state, tp)
        tp = to.apply_updates(tp, upd)
    return to_numpy(tp), state


def _assert_trees_close(got, want, rtol):
    to.tree_map_with_path(
        lambda p, a, b: np.testing.assert_allclose(a, b, rtol=rtol,
                                                   atol=1e-7, err_msg=p),
        got, want)


@pytest.mark.parametrize("freeze", [False, True])
def test_bert_adam_five_updates_match_jax(freeze):
    params, grads = _opt_tree(np.random.RandomState(0))
    kw = dict(optim_choice="bertadam", lr=1e-2, bert_lr=5e-3,
              warmup_proportion=0.3, t_total=6, freeze_encoder=freeze)
    want, _ = _jax_run(jo.OptimizerConfig(**kw), params, grads)
    got, state = _port_run(to.OptimizerConfig(**kw), params, grads)
    _assert_trees_close(got, want, rtol=1e-6)
    if freeze:
        to.tree_map(np.testing.assert_array_equal, got["encoder"],
                    params["encoder"])
    else:
        assert state.step == 5


def test_bert_adam_resumes_from_a_bridged_state():
    """Two JAX updates, the state bridged to the port, three more on both
    sides from that state."""
    params, grads = _opt_tree(np.random.RandomState(1))
    kw = dict(optim_choice="bertadam", lr=1e-2, bert_lr=5e-3,
              warmup_proportion=0.3, t_total=6)
    mid, jstate = _jax_run(jo.OptimizerConfig(**kw), params, grads[:2])
    jstate = jax.device_get(jstate)
    tstate = opt_state_from_numpy(jstate.step, jstate.m, jstate.v)
    step, m, v = opt_state_to_numpy(tstate)
    assert int(step) == 2
    to.tree_map(np.testing.assert_array_equal, m, jstate.m)
    want, _ = _jax_run(jo.OptimizerConfig(**kw), mid, grads[2:],
                       jo.BertAdamState(step=jnp.asarray(jstate.step),
                                        m=jstate.m, v=jstate.v))
    got, _ = _port_run(to.OptimizerConfig(**kw), mid, grads[2:], tstate)
    _assert_trees_close(got, want, rtol=1e-6)


@pytest.mark.parametrize("mode,extra", [("adam", {"l2": 0.01}),
                                        ("adamw", {})])
def test_adam_modes_one_update(mode, extra):
    params, grads = _opt_tree(np.random.RandomState(2))
    kw = dict(optim_choice=mode, lr=1e-2, bert_lr=5e-3,
              warmup_proportion=0.3, t_total=6, **extra)
    # adamw's first update trains at lr 0 (warmup from step 0): take two
    n = 2 if mode == "adamw" else 1
    want, _ = _jax_run(jo.OptimizerConfig(**kw), params, grads[:n])
    got, _ = _port_run(to.OptimizerConfig(**kw), params, grads[:n])
    _assert_trees_close(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="optim_choice"):
        to.make_optimizer(to.OptimizerConfig(optim_choice="sgd"), params)
