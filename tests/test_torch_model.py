"""The port's encoder and model forward against the JAX package on the
same parameters (bridged) and inputs: the plain path at the tiny config,
packed rows with per-segment positions and CLS gathers, and the
kernel-routable config (hidden 128) with the attention and FFN routes on,
the JAX side running its Pallas kernels in interpret mode.

f32, atol 1e-4: the same algorithm on both sides, differing in summation
order, in the Pallas GELU's A&S erf and in the head's group-softmax
exponentials; two layers and the head amplify ulp-level differences to
a few 1e-6 at most."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nbest_asr_tpu.data.packing import pack_train_data
from nbest_asr_tpu.models import encoder as jenc
from nbest_asr_tpu.models import model as jmodel
from nbest_asr_tpu.models.heads import \
    hierarchy_device_arrays as j_hier
from nbest_asr_tpu.train.decode import decode_multihot as j_decode
from nbest_asr_tpu_torch.models import encoder as tenc
from nbest_asr_tpu_torch.models import model as tmodel
from nbest_asr_tpu_torch.models.heads import \
    hierarchy_device_arrays as t_hier
from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.params_bridge import from_jax_numpy
from nbest_asr_tpu_torch.train.decode import decode_multihot as t_decode

ATOL = 1e-4
VOCAB = 67


def _configs(**kw):
    """(JAX ModelConfig, port ModelConfig) with identical fields."""
    jcfg = jenc.EncoderConfig(vocab_size=VOCAB, **kw)
    tcfg = tenc.EncoderConfig(vocab_size=VOCAB, **kw)
    return jcfg, tcfg


TINY = dict(hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)
ROUTABLE = dict(hidden_size=128, num_layers=2, num_heads=2,
                intermediate_size=256, max_position=64,
                use_fused_attn=True, use_fused_attn_eval=True,
                use_fused_ffn=True)


def _inputs(seed, b=3, s=24):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (b, s)).astype(np.int32)
    mask = (rng.rand(b, s) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    segs = (rng.rand(b, s) > 0.5).astype(np.int32)
    return ids, mask, segs


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("which", ["tiny", "routable"])
def test_encoder_forward_matches_jax(which):
    jcfg, tcfg = _configs(**(TINY if which == "tiny" else ROUTABLE))
    params = jax.device_get(jenc.init_encoder_params(
        jax.random.PRNGKey(0), jcfg))
    ids, mask, segs = _inputs(1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jenc.encoder_forward(
            params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(segs),
            jcfg, deterministic=True))
    _cuda.reset_launch_counts()
    got = tenc.encoder_forward(from_jax_numpy(params), _t(ids), _t(mask),
                               _t(segs), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert all(v == 0 for v in _cuda.launch_counts.values())


def test_routing_matches_jax_rules():
    _, tcfg = _configs(**ROUTABLE)
    assert tenc.attn_kernel_routes(tcfg, 512)
    assert not tenc.attn_kernel_routes(tcfg, 513)
    assert not tenc.attn_kernel_routes(
        dataclasses.replace(tcfg, use_fused_attn_eval=False), 64)
    assert tenc.ffn_kernel_routes(tcfg)
    _, tiny = _configs(**TINY, use_fused_attn=True, use_fused_attn_eval=True,
                       use_fused_ffn=True)
    assert not tenc.attn_kernel_routes(tiny, 64)     # hidden 64: lanes
    assert not tenc.ffn_kernel_routes(tiny)


def test_head_dim_192_eval_routes_to_the_attention_kernels(monkeypatch):
    """Head dim 192 (hidden 384, 2 heads): JAX's eval forward runs its
    attention megakernel (``attn_lanes_ok``), and so does the port -- the
    layer goes to ``fused_attention_block`` (whose kernels now take d =
    192), not to the plain path -- with the same result."""
    from nbest_asr_tpu_torch.ops import fused_attention as tfa

    kw = dict(ROUTABLE, hidden_size=384, num_layers=1, use_fused_ffn=False)
    jcfg, tcfg = _configs(**kw)
    assert tcfg.head_dim == 192 and tenc.attn_kernel_routes(tcfg, 24)
    params = jax.device_get(jenc.init_encoder_params(
        jax.random.PRNGKey(4), jcfg))
    ids, mask, segs = _inputs(5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jenc.encoder_forward(
            params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(segs),
            jcfg, deterministic=True))
    calls = []
    block = tfa.fused_attention_block
    monkeypatch.setattr(tfa, "fused_attention_block",
                        lambda *a, **k: calls.append(1) or block(*a, **k))
    got = tenc.encoder_forward(from_jax_numpy(params), _t(ids), _t(mask),
                               _t(segs), tcfg).numpy()
    assert len(calls) == 1
    np.testing.assert_allclose(got, want, atol=ATOL)


def _model_pair(which, memory):
    jcfg, tcfg = _configs(**(TINY if which == "tiny" else ROUTABLE))
    jm = jmodel.ModelConfig(encoder=jcfg, n_top=memory.n_top,
                            n_bottom=memory.n_bottom)
    tm = tmodel.ModelConfig(encoder=tcfg, n_top=memory.n_top,
                            n_bottom=memory.n_bottom)
    params = jax.device_get(jmodel.init_model_params(
        jax.random.PRNGKey(2), jm))
    return jm, tm, params


def _compare_model(jm, tm, params, memory, args, kw):
    jh = j_hier(memory.arrays())
    th = t_hier(memory.arrays())
    with pltpu.force_tpu_interpret_mode():
        j_top, j_probs, j_final, _, _ = jmodel.model_forward(
            params, jm, jh, *(jnp.asarray(a) for a in args),
            deterministic=True, **{k: jnp.asarray(v) for k, v in kw.items()})
        j_pred = np.asarray(j_decode(j_top, j_probs, jh))
    t_top, t_probs, t_final, _, _ = tmodel.model_forward(
        from_jax_numpy(params), tm, th, *(_t(a) for a in args),
        **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(t_top.numpy(), np.asarray(j_top), atol=ATOL)
    np.testing.assert_allclose(t_probs.numpy(), np.asarray(j_probs),
                               atol=ATOL)
    np.testing.assert_allclose(t_final.numpy(), np.asarray(j_final),
                               atol=ATOL)
    np.testing.assert_array_equal(t_decode(t_top, t_probs, th).numpy(),
                                  j_pred)


@pytest.mark.parametrize("which", ["tiny", "routable"])
def test_model_forward_matches_jax(which, tiny_memory):
    jm, tm, params = _model_pair(which, tiny_memory)
    _compare_model(jm, tm, params, tiny_memory, _inputs(3, b=5, s=20), {})


@pytest.mark.parametrize("which", ["tiny", "routable"])
def test_packed_model_forward_matches_jax(which, tiny_memory):
    """Several utterances per row: segment-id mask, per-segment position
    ids and per-segment CLS gathers."""
    rng = np.random.RandomState(4)
    n, max_len = 11, 20
    lens = rng.randint(4, max_len + 1, size=n)
    ids = np.zeros((n, max_len), np.int32)
    mask = np.zeros((n, max_len), np.float32)
    for i, L in enumerate(lens):
        ids[i, :L] = rng.randint(2, VOCAB, size=L)
        mask[i, :L] = 1.0
    segs = np.zeros_like(ids)
    data = {"input_ids": ids, "attn_mask": mask, "segment_ids": segs,
            "trans_input_ids": ids, "trans_attn_mask": mask,
            "trans_segment_ids": segs,
            "labels": np.zeros((n, tiny_memory.n_bottom), np.float32)}
    pk, bins = pack_train_data(data, capacity=48, max_segs=3)
    assert any(len(b) >= 2 for b in bins), "case must actually pack"
    jm, tm, params = _model_pair(which, tiny_memory)
    _compare_model(
        jm, tm, params, tiny_memory,
        (pk["input_ids"], pk["attn_mask"], pk["segment_ids"]),
        {"position_ids": pk["position_ids"],
         "cls_positions": pk["cls_pos"]})


def test_decode_ties_go_to_first_index(tiny_memory):
    """Equal group probabilities: both packages pick the lowest index."""
    jh = j_hier(tiny_memory.arrays())
    th = t_hier(tiny_memory.arrays())
    top = np.full((2, tiny_memory.n_top), 0.9, np.float32)
    probs = np.full((2, tiny_memory.n_bottom), 0.5, np.float32)
    want = np.asarray(j_decode(jnp.asarray(top), jnp.asarray(probs), jh))
    got = t_decode(_t(top), _t(probs), th).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any()
