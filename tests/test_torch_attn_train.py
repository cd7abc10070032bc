"""The port's attention block for training (``ops/fused_attention.py``:
the autograd Function over the forward and backward kernel chains; on
the CPU their plain versions) against the JAX ``fused_attention_block``
run under ``pltpu.force_tpu_interpret_mode()``, as
``tests/test_fused_attention.py`` runs it, in f32 at h = 128, 2 heads,
d = 64: forward 2e-5 / 1e-4, all seven gradients 5e-4 / 2e-3 (summation
orders differ; the softmax gradient's p * (dp - di) cancels to a few
1e-6).  The JAX interpret-mode PRNG is all zeros, so dropout is never
compared with JAX: with dropout the Function is held to torch autograd
through ``fused_attention_block_reference`` on the same Philox masks
(streams 3 and 4), and the plain backward ``seg_attention_bwd_reference``
to autograd through the plain forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nbest_asr_tpu.ops.fused_attention import \
    fused_attention_block as jax_fab
from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.ops import kernels as K
from nbest_asr_tpu_torch.ops.fused_attention import (
    fused_attention_block, fused_attention_block_reference)
from nbest_asr_tpu_torch.ops.philox import (STREAM_ATTN_HIDDEN,
                                            STREAM_ATTN_PROB, keep_mask, site)

H, NH = 128, 2
EPS = 1e-12
NAMES = ("x", "wqkv", "bqkv", "wo", "bo", "ln_scale", "ln_bias")


def _mask(rng, b, s, kind):
    """padded: real tokens then pads; packed: segments 1, 2, 3, pads."""
    m = np.zeros((b, s), np.float32)
    for i in range(b):
        if kind == "padded":
            m[i, :rng.randint(s // 2, s + 1)] = 1.0
        else:
            c = np.sort(rng.choice(np.arange(1, s), size=3, replace=False))
            m[i, :c[0]], m[i, c[0]:c[1]], m[i, c[1]:c[2]] = 1, 2, 3
    m[:, 0] = np.maximum(m[:, 0], 1.0)
    return m


def _inputs(b, s, kind, seed=0, h=H):
    rng = np.random.RandomState(seed)
    args = [(rng.randn(b, s, h) * 0.5).astype(np.float32),
            (rng.randn(h, 3 * h) * 0.05).astype(np.float32),
            (rng.randn(3 * h) * 0.02).astype(np.float32),
            (rng.randn(h, h) * 0.05).astype(np.float32),
            (rng.randn(h) * 0.02).astype(np.float32),
            (1.0 + 0.1 * rng.randn(h)).astype(np.float32),
            (0.1 * rng.randn(h)).astype(np.float32)]
    return args, _mask(rng, b, s, kind)


def _torch_grads(fn, args, mask, n_heads=NH, **kw):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    y = fn(*ts, torch.from_numpy(mask), n_heads=n_heads, eps=EPS, **kw)
    (y * y).sum().backward()
    return y.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("b,s,kind", [(2, 64, "padded"), (3, 20, "padded"),
                                      (2, 48, "packed"), (1, 300, "padded"),
                                      (1, 512, "packed")])
def test_forward_and_all_gradients_match_pallas(b, s, kind):
    _hold_to_pallas(*_inputs(b, s, kind, seed=b * 100 + s), NH)


@pytest.mark.parametrize("b,s,kind", [(1, 300, "padded"), (1, 512, "packed")])
def test_d192_heads_past_256_keys_match_pallas(b, s, kind):
    """h = 384 in 2 heads of 192, past 256 keys: the head dim and lengths
    that the card runs on its streaming d = 192 wgmma pair."""
    _hold_to_pallas(*_inputs(b, s, kind, seed=b * 100 + s, h=384), 2)


def _hold_to_pallas(args, mask, n_heads):
    def loss(*a):
        out = jax_fab(*a, jnp.asarray(mask), n_heads=n_heads, eps=EPS)
        return jnp.sum(out * out)

    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        ja = [jnp.asarray(a) for a in args]
        want_y = np.asarray(jax_fab(*ja, jnp.asarray(mask), n_heads=n_heads,
                                    eps=EPS))
        want_g = jax.grad(loss, argnums=tuple(range(7)))(*ja)
    _cuda.reset_launch_counts()
    y, grads = _torch_grads(fused_attention_block, args, mask, n_heads)
    assert all(v == 0 for v in _cuda.launch_counts.values())
    np.testing.assert_allclose(y.numpy(), want_y, atol=2e-5, rtol=1e-4)
    for g, w, name in zip(grads, want_g, NAMES):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=2e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("rate", [0.1, 0.25])
def test_dropout_gradients_match_autograd_of_plain_block(rate):
    args, mask = _inputs(3, 20, "packed", seed=7)
    kw = dict(attn_dropout=rate, hidden_dropout=rate, seed=11)
    y, grads = _torch_grads(fused_attention_block, args, mask, **kw)
    ry, rgrads = _torch_grads(fused_attention_block_reference, args, mask,
                              **kw)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), atol=1e-5)
    for g, r, name in zip(grads, rgrads, NAMES):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")
    # the masks are on: another seed, or no dropout, gives another block
    y2, _ = _torch_grads(fused_attention_block, args, mask,
                         attn_dropout=rate, hidden_dropout=rate, seed=12)
    y0, _ = _torch_grads(fused_attention_block, args, mask)
    assert not torch.equal(y, y2) and not torch.equal(y, y0)


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("kind", ["padded", "packed"])
def test_seg_attention_bwd_reference_matches_autograd(kind, rate):
    rng = np.random.RandomState(3)
    b, s = 2, 40
    qkv = torch.from_numpy(rng.randn(b * s, 3 * H).astype(np.float32))
    dctx = torch.from_numpy(rng.randn(b * s, H).astype(np.float32))
    mask = torch.from_numpy(_mask(rng, b, s, kind))
    drop = site(5, rate, STREAM_ATTN_PROB)
    q = qkv.clone().requires_grad_(True)
    ctx, stats = K.seg_attention(q, mask, NH, drop=drop, stats=True)
    ctx.backward(dctx)
    got = K.seg_attention_bwd(qkv, dctx, mask, stats.detach(), NH, drop)
    assert got.shape == qkv.shape
    np.testing.assert_allclose(got.numpy(), q.grad.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert stats.shape == (2, b, NH, s)


@pytest.mark.parametrize("rate", [0.1, 0.25])
def test_keep_rates_of_the_attention_streams(rate):
    b, s = 16, 96
    for stream, rows, cols in ((STREAM_ATTN_PROB, b * NH * s, s),
                               (STREAM_ATTN_HIDDEN, b * s, 768)):
        m = keep_mask(77, stream, 0, rows, cols, rate)
        assert abs(m.float().mean().item() - (1 - rate)) <= \
            4 * np.sqrt(rate * (1 - rate) / m.numel())
    assert not torch.equal(keep_mask(77, STREAM_ATTN_PROB, 0, 64, 64, rate),
                           keep_mask(77, STREAM_ATTN_HIDDEN, 0, 64, 64, rate))


def test_prob_mask_rows_and_subranges():
    """The prob mask of (element, head) is rows (elem * n_heads + head) *
    s .. + s of stream 3, a row sub-range of the mask is that slice of
    the whole, and the forward drops exactly those probs."""
    b, s, rate = 3, 20, 0.25
    whole = keep_mask(9, STREAM_ATTN_PROB, 0, b * NH * s, s, rate)
    for r0, n in ((0, 7), (13, 29), (b * NH * s - 5, 5)):
        assert torch.equal(keep_mask(9, STREAM_ATTN_PROB, r0, n, s, rate),
                           whole[r0:r0 + n])
    rng = np.random.RandomState(4)
    qkv = torch.from_numpy(rng.randn(b * s, 3 * H).astype(np.float32))
    mask = torch.from_numpy(_mask(rng, b, s, "packed"))
    got = K.seg_attention(qkv, mask, NH,
                          drop=site(9, rate, STREAM_ATTN_PROB))
    _, stats = K.seg_attention(qkv, mask, NH, stats=True)
    _, _, v, sc, _ = K._scores(qkv, mask, NH)
    p = torch.exp(sc - stats[0][..., None]) / stats[1][..., None]
    inv = torch.tensor(1.0 / (1.0 - rate))
    pd = torch.zeros_like(p)
    for e in range(b):
        for hd in range(NH):
            keep = keep_mask(9, STREAM_ATTN_PROB, (e * NH + hd) * s, s, s,
                             rate)
            pd[e, hd] = torch.where(keep, p[e, hd] * inv, torch.zeros(()))
    want = torch.einsum("bhqk,bkhd->bqhd", pd, v).reshape(b * s, H)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_backward_regenerates_the_forward_hidden_mask():
    args, mask = _inputs(2, 24, "padded", seed=13)
    x, wqkv, bqkv, wo, bo, ls, lb = (torch.from_numpy(a) for a in args)
    n = 2 * 24
    x2 = x.reshape(n, H)
    dh = site(21, 0.25, STREAM_ATTN_HIDDEN)
    qkv = K.gemm_bias_act(x2, wqkv, bqkv)
    c = K.seg_attention(qkv, torch.from_numpy(mask), NH)
    s_, od = K.gemm_bias_residual(c, wo, bo, x2, drop=dh, save_y2d=True)
    _, mean, rstd = K.layer_norm_rows(s_, ls, lb, EPS, x2.dtype, stats=True)
    dy = torch.randn(n, H, generator=torch.Generator().manual_seed(0))
    dout, _, _ = K.ffn_bwd_rows(x2, od, dy, ls, mean, rstd, drop=dh)
    k4 = keep_mask(21, STREAM_ATTN_HIDDEN, 0, n, H, 0.25)
    assert torch.equal(od == 0, ~k4) and torch.equal(dout == 0, ~k4)
    assert torch.equal(s_[~k4], x2[~k4])


def test_none_dgrad_epilogue_and_refusals():
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.randn(30, H).astype(np.float32))
    w = torch.from_numpy(rng.randn(H, H).astype(np.float32))
    np.testing.assert_allclose(K.gemm_dgrad(a, w, "none").numpy(),
                               (a @ w.t()).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="no dropout"):
        K.gemm_dgrad(a, w, "none", drop=site(1, 0.1, STREAM_ATTN_HIDDEN))
    x = torch.zeros(2, 16, H)
    p = [torch.zeros(H, 3 * H), torch.zeros(3 * H), torch.zeros(H, H),
         torch.zeros(H), torch.ones(H), torch.zeros(H)]
    with pytest.raises(ValueError, match="seed"):
        fused_attention_block(x, *p, torch.ones(2, 16), n_heads=NH,
                              attn_dropout=0.1)
    with pytest.raises(ValueError, match="not in"):
        fused_attention_block(x, *p, torch.ones(2, 16), n_heads=NH,
                              hidden_dropout=1.0, seed=1)
