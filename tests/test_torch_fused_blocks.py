"""The port's attention and FFN blocks (on the CPU: their plain
versions) against the JAX Pallas megakernels run in interpret mode, as
``tests/test_fused_attention.py`` runs them.

f32, atol 1e-4: the Pallas side computes its GELU with the A&S 7.1.26
erf polynomial (max error 1.5e-7) and both sides sum in different
orders; through two GEMMs and a LayerNorm that divides by a small
row std, element errors reach a few 1e-6, so 1e-4 leaves margin without
hiding a wrong rounding point or mask (either shows at >= 1e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nbest_asr_tpu.ops.fused_attention import \
    fused_attention_block as jax_fab
from nbest_asr_tpu.ops.fused_ffn import fused_ffn_block as jax_ffn
from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.ops.fused_attention import (
    fused_attention_block, fused_attention_block_reference)
from nbest_asr_tpu_torch.ops.fused_ffn import (fused_ffn_block,
                                               fused_ffn_block_reference)

ATOL = 1e-4
H, NH, INTER = 128, 2, 256
SHAPES = [(3, 20), (4, 16), (2, 130)]


def _attn_params(rng, h):
    return dict(
        wqkv=(rng.randn(h, 3 * h) * 0.05).astype(np.float32),
        bqkv=(rng.randn(3 * h) * 0.02).astype(np.float32),
        wo=(rng.randn(h, h) * 0.05).astype(np.float32),
        bo=(rng.randn(h) * 0.02).astype(np.float32),
        ls=(1.0 + 0.1 * rng.randn(h)).astype(np.float32),
        lb=(0.1 * rng.randn(h)).astype(np.float32),
    )


def _ffn_params(rng, h, inter):
    return dict(
        w1=(rng.randn(h, inter) * 0.05).astype(np.float32),
        b1=(rng.randn(inter) * 0.02).astype(np.float32),
        w2=(rng.randn(inter, h) * 0.05).astype(np.float32),
        b2=(rng.randn(h) * 0.02).astype(np.float32),
        ls=(1.0 + 0.1 * rng.randn(h)).astype(np.float32),
        lb=(0.1 * rng.randn(h)).astype(np.float32),
    )


def _mask(rng, b, s, kind):
    if kind == "padded":
        m = (rng.rand(b, s) > 0.2).astype(np.float32)
        m[:, 0] = 1.0
        return m
    m = np.zeros((b, s), np.float32)     # packed: segments 1, 2, 3, pads
    for i in range(b):
        c = np.sort(rng.choice(np.arange(1, s), size=3, replace=False))
        m[i, :c[0]], m[i, c[0]:c[1]], m[i, c[1]:c[2]] = 1, 2, 3
    return m


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("kind", ["padded", "packed"])
@pytest.mark.parametrize("b,s", SHAPES)
def test_attention_block_matches_pallas(b, s, kind):
    rng = np.random.RandomState(b * 100 + s + (kind == "packed"))
    x = (rng.randn(b, s, H) * 0.5).astype(np.float32)
    p = _attn_params(rng, H)
    mask = _mask(rng, b, s, kind)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fab(
            jnp.asarray(x), *(jnp.asarray(p[k]) for k in
                              ("wqkv", "bqkv", "wo", "bo", "ls", "lb")),
            jnp.asarray(mask), n_heads=NH))
    _cuda.reset_launch_counts()
    args = [_t(x)] + [_t(p[k]) for k in
                      ("wqkv", "bqkv", "wo", "bo", "ls", "lb")] + [_t(mask)]
    got = fused_attention_block(*args, n_heads=NH).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    ref = fused_attention_block_reference(*args, n_heads=NH).numpy()
    np.testing.assert_array_equal(got, ref)
    assert all(v == 0 for v in _cuda.launch_counts.values())


@pytest.mark.parametrize("b,s", SHAPES)
def test_ffn_block_matches_pallas(b, s):
    rng = np.random.RandomState(7 * b + s)
    x = (rng.randn(b, s, H) * 0.5).astype(np.float32)
    p = _ffn_params(rng, H, INTER)
    names = ("w1", "b1", "w2", "b2", "ls", "lb")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_ffn(jnp.asarray(x),
                                  *(jnp.asarray(p[k]) for k in names)))
    _cuda.reset_launch_counts()
    args = [_t(x)] + [_t(p[k]) for k in names]
    got = fused_ffn_block(*args).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got, fused_ffn_block_reference(*args)
                                  .numpy())
    assert all(v == 0 for v in _cuda.launch_counts.values())


def test_dropout_rate_raises():
    x = torch.zeros(2, 16, H)
    rng = np.random.RandomState(0)
    pa = {k: _t(v) for k, v in _attn_params(rng, H).items()}
    pf = {k: _t(v) for k, v in _ffn_params(rng, H, INTER).items()}
    mask = torch.ones(2, 16)
    # both blocks train with Philox dropout (test_torch_attn_train.py,
    # test_torch_ffn_train.py); a rate without its seed is refused
    with pytest.raises(ValueError, match="dropout"):
        fused_attention_block(x, pa["wqkv"], pa["bqkv"], pa["wo"],
                              pa["bo"], pa["ls"], pa["lb"], mask,
                              n_heads=NH, attn_dropout=0.1)
    with pytest.raises(ValueError, match="dropout"):
        fused_attention_block(x, pa["wqkv"], pa["bqkv"], pa["wo"],
                              pa["bo"], pa["ls"], pa["lb"], mask,
                              n_heads=NH, hidden_dropout=0.1)
    with pytest.raises(ValueError, match="dropout"):
        fused_ffn_block(x, pf["w1"], pf["b1"], pf["w2"], pf["b2"],
                        pf["ls"], pf["lb"], dropout_rate=0.1)
