"""``remat`` in the port's encoder (``models/encoder.py:_run_layer``: each
training layer under a non-reentrant ``torch.utils.checkpoint``) on the
CPU.

(a) In training with dropout 0.1, f32, on every route the encoder takes
-- the plain blocks, both blocks' training Functions, flash attention
and route C's row Functions (their plain versions on the CPU) -- the loss
and every gradient with ``remat`` are bit-equal to those without: the
recompute redraws each dropout mask from the layer's seed.  (b) At
dropout 0 in training mode the port with ``remat`` matches JAX's
``encoder_forward`` with ``cfg.remat`` (``jax.checkpoint`` over the layer
scan) on parameters carried by ``params_bridge``: the output within
1e-5, every gradient within 1e-5 times the larger of 1 and its leaf's
largest.  (c) Under tp = 2 over two spawned gloo ranks
(``torch_dist_worker.py steps``), three train steps with dropout 0.1 and
``remat`` leave every parameter bit-equal to the same steps without it:
the recompute re-runs the layer's tp all-reduces in the same order on
both ranks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbest_asr_tpu.models import encoder as jenc
from nbest_asr_tpu_torch.models import encoder as tenc
from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.params_bridge import from_jax_numpy
from nbest_asr_tpu_torch.train.optimizer import tree_leaves, tree_map
from torch_dist_worker import flat, spawn

VOCAB = 67
ROUTES = {
    "plain": dict(hidden_size=64, num_heads=4, intermediate_size=128),
    "blocks": dict(hidden_size=128, num_heads=2, intermediate_size=256,
                   use_fused_attn=True, use_fused_ffn=True),
    "flash": dict(hidden_size=128, num_heads=4, intermediate_size=256,
                  use_flash_attention=True, flash_min_seq=16),
    "rows": dict(hidden_size=64, num_heads=4, intermediate_size=128,
                 use_fused_ln=True, use_fused_gelu=True,
                 use_fused_embedding=True),
}


def _inputs(seed, b=3, s=24):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (b, s)).astype(np.int32)
    mask = (rng.rand(b, s) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    segs = (rng.rand(b, s) > 0.5).astype(np.int32)
    return ids, mask, segs


def _probe(shape):
    """A fixed random projection: the loss sum(y * probe) (a sum of
    squares of LayerNorm outputs would leave every gradient upstream of
    the last LN at rounding noise)."""
    return np.random.RandomState(5).randn(*shape).astype(np.float32)


def _port_grads(params, cfg, ids, mask, segs, seed=11):
    """(output, loss, gradients) of ``sum(y * probe)`` over the port's
    training forward ``y``."""
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    y = tenc.encoder_forward(live, torch.from_numpy(ids),
                             torch.from_numpy(mask), torch.from_numpy(segs),
                             cfg, deterministic=False, seed=seed)
    loss = (y.float() * torch.from_numpy(_probe(tuple(y.shape)))).sum()
    return y.detach(), loss.detach(), torch.autograd.grad(
        loss, leaves, allow_unused=True)


@pytest.mark.parametrize("route", list(ROUTES))
def test_remat_is_bit_equal_to_no_remat(route):
    cfg = tenc.EncoderConfig(vocab_size=VOCAB, num_layers=2,
                             max_position=64, hidden_dropout=0.1,
                             attn_dropout=0.1, **ROUTES[route])
    params = tenc.init_encoder_params(torch.Generator().manual_seed(0), cfg)
    ids, mask, segs = _inputs(1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # CPU torch sums in thread order
    _cuda.reset_launch_counts()
    try:
        y0, l0, g0 = _port_grads(params, cfg, ids, mask, segs)
        y1, l1, g1 = _port_grads(
            params, dataclasses.replace(cfg, remat=True), ids, mask, segs)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(y0, y1) and torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)
    assert sum(g is not None for g in g0) == len(g0)
    assert all(v == 0 for v in _cuda.launch_counts.values())


def test_remat_matches_jax_remat():
    kw = dict(hidden_size=64, num_layers=2, num_heads=4,
              intermediate_size=128, max_position=64, hidden_dropout=0.0,
              attn_dropout=0.0, remat=True)
    jcfg = jenc.EncoderConfig(vocab_size=VOCAB, **kw)
    tcfg = tenc.EncoderConfig(vocab_size=VOCAB, **kw)
    params = jax.device_get(jenc.init_encoder_params(
        jax.random.PRNGKey(0), jcfg))
    ids, mask, segs = _inputs(2)

    def loss(p):
        y = jenc.encoder_forward(p, jnp.asarray(ids), jnp.asarray(mask),
                                 jnp.asarray(segs), jcfg,
                                 deterministic=False,
                                 rng=jax.random.PRNGKey(1))
        return (y.astype(jnp.float32)
                * jnp.asarray(_probe(tuple(y.shape)))).sum(), y

    (want_loss, want_y), want_g = jax.value_and_grad(
        loss, has_aux=True)(params)
    tparams = from_jax_numpy(params)
    y, got_loss, got_g = _port_grads(tparams, tcfg, ids, mask, segs)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    want_leaves = tree_leaves(from_jax_numpy(jax.device_get(want_g)))
    for g, w in zip(got_g, want_leaves):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(),
                                   atol=1e-5 * max(scale, 1.0))


def test_remat_under_tp2_is_bit_equal(tiny_memory, tmp_path):
    from nbest_asr_tpu_torch.models.model import (ModelConfig,
                                                  init_model_params)

    enc = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position=320, hidden_dropout=0.1,
               attn_dropout=0.1, compute_dtype="float32")
    cfg = ModelConfig(encoder=tenc.EncoderConfig(**enc),
                      n_top=tiny_memory.n_top, n_bottom=tiny_memory.n_bottom)
    params = init_model_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.RandomState(0)
    labels = np.zeros((16, tiny_memory.n_bottom), np.float32)
    labels[np.arange(16), rng.randint(2, tiny_memory.n_bottom, 16)] = 1
    arrays = {f"p/{k}": v.numpy() for k, v in flat(params).items()}
    arrays.update({
        "d/input_ids": rng.randint(1, 64, (16, 16)).astype(np.int32),
        "d/attn_mask": np.ones((16, 16), np.float32),
        "d/segment_ids": np.zeros((16, 16), np.int32),
        "d/trans_input_ids": rng.randint(1, 64, (16, 16)).astype(np.int32),
        "d/trans_attn_mask": np.ones((16, 16), np.float32),
        "d/trans_segment_ids": np.zeros((16, 16), np.int32),
        "d/labels": labels,
        "idx": np.tile(np.arange(16, dtype=np.int32).reshape(2, 8),
                       (3, 1, 1)),
    })
    tiny_memory.save(str(tmp_path / "memory.json"))
    outs = []
    for remat in (False, True):
        spec = dict(memory=str(tmp_path / "memory.json"),
                    encoder=dict(enc, remat=remat),
                    optimizer=dict(optim_choice="bertadam", lr=1e-3,
                                   bert_lr=1e-3, t_total=100),
                    n_dcn=1, n_data=1, n_model=2, n_accum=2, l2=True)
        outs.append(spawn("steps", 2, tmp_path / f"remat{remat}", spec,
                          arrays))
    for (js0, p0), (js1, p1) in zip(*outs):
        assert sorted(p0) == sorted(p1)
        for k in p0:
            np.testing.assert_array_equal(p1[k], p0[k], err_msg=k)
        assert js0["stats"] == js1["stats"]
