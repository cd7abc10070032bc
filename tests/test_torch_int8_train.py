"""The port's int8 training blocks (``ops/fused_ffn.py:
fused_ffn_block_int8_train``, ``ops/fused_attention.py:
fused_attention_block_int8_train``: autograd Functions over the int8
forward chains and either the bf16 backward after a bf16 recompute
(``int8_bwd=False``) or the int8-dgrad backward; on the CPU their
kernels' plain versions) against the JAX functions of the same names run
under ``pltpu.force_tpu_interpret_mode()``, in f32 at h = 128, inter =
256, 2 heads of 64, with the inputs ``tests/test_int8_train.py`` builds.
Tolerances are the JAX package's own for these functions
(``tests/test_int8_train.py``): forward 3e-5 / 1e-4; straight-through
gradients (``int8_bwd=False``) 5e-4 / 5e-3; int8-dgrad gradients 1e-3 /
1e-2 for the FFN and 2e-3 / 1e-2 for the attention block.  The Pallas
side's erf is the A&S 7.1.26 polynomial (max error 1.5e-7) and the port's
the exact one; a difference that small could flip one int8 rounding of
gd / scale, which would move the FFN forward by ~1e-3, but on these inputs
the forwards agree to within 1e-6.  The JAX interpret-mode PRNG is all
zeros, so dropout is held to the Philox masks and to determinism
instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nbest_asr_tpu.ops import fused_ffn as jffn
from nbest_asr_tpu.ops import quant as jquant
from nbest_asr_tpu.ops.fused_attention import \
    fused_attention_block_int8_train as jax_attn_i8
from nbest_asr_tpu.ops.fused_ffn import \
    fused_ffn_block_int8_train as jax_ffn_i8
from nbest_asr_tpu.ops.int8_serving import _dense_i8 as jax_dense_i8
from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.ops import fused_attention as fa
from nbest_asr_tpu_torch.ops import fused_ffn as ff
from nbest_asr_tpu_torch.ops import kernels as K
from nbest_asr_tpu_torch.ops.philox import Dropout, keep_mask
from nbest_asr_tpu_torch.ops.quant import (dgrad_int8, kernel_layout,
                                           quantize_rows_reference,
                                           quantize_train_weight,
                                           quantize_weight)

H, INTER, NH = 128, 256, 2
EPS = 1e-12
FFN_NAMES = ("x", "w1", "b1", "w2", "b2", "ln_scale", "ln_bias")
ATTN_NAMES = ("x", "wqkv", "bqkv", "wo", "bo", "ln_scale", "ln_bias")
GRAD_TOL = {("ffn", False): (5e-4, 5e-3), ("ffn", True): (1e-3, 1e-2),
            ("attn", False): (5e-4, 5e-3), ("attn", True): (2e-3, 1e-2)}


def _ffn_inputs(n=48, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n, H) * 0.5).astype(np.float32),
            (rng.randn(H, INTER) * 0.05).astype(np.float32),
            (rng.randn(INTER) * 0.02).astype(np.float32),
            (rng.randn(INTER, H) * 0.05).astype(np.float32),
            (rng.randn(H) * 0.02).astype(np.float32),
            (1.0 + 0.1 * rng.randn(H)).astype(np.float32),
            (0.1 * rng.randn(H)).astype(np.float32)]


def _attn_inputs(b=2, s=48, seed=7, kind="padded"):
    rng = np.random.RandomState(seed)
    args = [(rng.randn(b, s, H) * 0.5).astype(np.float32),
            (rng.randn(H, 3 * H) * 0.05).astype(np.float32),
            (rng.randn(3 * H) * 0.02).astype(np.float32),
            (rng.randn(H, H) * 0.05).astype(np.float32),
            (rng.randn(H) * 0.02).astype(np.float32),
            (1.0 + 0.1 * rng.randn(H)).astype(np.float32),
            (0.1 * rng.randn(H)).astype(np.float32)]
    if kind == "padded":
        lens = np.full((b,), s)
        lens[1::2] = s - 9           # alternate full/short rows
        mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.float32)
    else:                            # packed segments 1, 2, 3, then pads
        mask = np.zeros((b, s), np.float32)
        for i in range(b):
            c = np.sort(rng.choice(np.arange(1, s), 3, replace=False))
            mask[i, :c[0]], mask[i, c[0]:c[1]], mask[i, c[1]:c[2]] = 1, 2, 3
    return args, mask


def _jax_grads(fn, args, **kw):
    def loss(*a):
        return jnp.sum(fn(*a, **kw) ** 2)

    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        ja = [jnp.asarray(a) for a in args]
        y = np.asarray(fn(*ja, **kw))
        g = jax.grad(loss, argnums=tuple(range(7)))(*ja)
    return y, [np.asarray(t) for t in g]


def _torch_grads(fn, args, *extra, **kw):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    y = fn(*ts, *extra, eps=EPS, **kw)
    (y * y).sum().backward()
    return y.detach(), [t.grad for t in ts]


def _hold(y, grads, want_y, want_g, names, tol):
    np.testing.assert_allclose(y.numpy(), want_y, atol=3e-5, rtol=1e-4)
    for g, w, name in zip(grads, want_g, names):
        np.testing.assert_allclose(g.numpy(), w, atol=tol[0], rtol=tol[1],
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("int8_bwd", [False, True], ids=["bf16_bwd",
                                                         "int8_bwd"])
def test_ffn_forward_and_gradients_match_pallas(int8_bwd):
    args = _ffn_inputs(seed=13 if int8_bwd else 3)
    want_y, want_g = _jax_grads(jax_ffn_i8, args, eps=EPS,
                                int8_bwd=int8_bwd)
    _cuda.reset_launch_counts()
    y, grads = _torch_grads(ff.fused_ffn_block_int8_train, args,
                            int8_bwd=int8_bwd)
    assert all(v == 0 for v in _cuda.launch_counts.values())
    _hold(y, grads, want_y, want_g, FFN_NAMES, GRAD_TOL[("ffn", int8_bwd)])


@pytest.mark.parametrize("kind", ["padded", "packed"])
@pytest.mark.parametrize("int8_bwd", [False, True], ids=["bf16_bwd",
                                                         "int8_bwd"])
def test_attention_forward_and_gradients_match_pallas(int8_bwd, kind):
    args, mask = _attn_inputs(s=32 if int8_bwd else 48,
                              seed=21 if int8_bwd else 11, kind=kind)
    want_y, want_g = _jax_grads(
        lambda *a, **kw: jax_attn_i8(*a, jnp.asarray(mask), **kw), args,
        n_heads=NH, eps=EPS, int8_bwd=int8_bwd)
    y, grads = _torch_grads(fa.fused_attention_block_int8_train, args,
                            torch.from_numpy(mask), n_heads=NH,
                            int8_bwd=int8_bwd)
    _hold(y, grads, want_y, want_g, ATTN_NAMES,
          GRAD_TOL[("attn", int8_bwd)])


def test_dgrad_int8_matches_jax_and_the_kernel_pair():
    """``quant.dgrad_int8`` equals JAX's bit for bit, and so does the plain
    pair the kernels follow: ``quantize_grad_rows`` then ``gemm_i8_dgrad``
    on the row-major weight."""
    rng = np.random.RandomState(0)
    w = rng.randn(64, 96).astype(np.float32)
    g = rng.randn(8, 96).astype(np.float32)
    jq, js = jquant.quantize_weight(jnp.asarray(w), axis_in=-2)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jquant.dgrad_int8(jnp.asarray(g), jq, js))
    _, wq, ws = quantize_train_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq))
    got = dgrad_int8(torch.from_numpy(g), wq, ws)
    np.testing.assert_array_equal(got.numpy(), want)
    pair = K.gemm_i8_dgrad(*K.quantize_grad_rows(torch.from_numpy(g), ws),
                           wq, "none", out_dtype=torch.float32)
    np.testing.assert_array_equal(pair.numpy(), want)


# Rows around the s8 wgmma GEMM's 192-row tile and depths that half-fill
# its 128-deep stage (K = 64 * odd): the plain versions the card tests hold
# gemm_i8_bias_act and gemm_i8_dgrad to, against JAX's int8 products at
# those shapes.  N = 256: two 128-column tiles.
TILE_M = (1, 191, 193)
TILE_K = (64, 192, 768)
TILE_N = 256


def _bf16_bits(t):
    """bf16 values as int16 bit patterns (numpy has no bf16)."""
    return t.contiguous().view(torch.int16).numpy()


def _jax_bf16_bits(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16).view(torch.int16).numpy()


def _bf16_ulps(got, want32):
    """Largest |got - want| in bf16 ulps of ``want``, f32 arrays."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want32), 2.0 ** -126)))
                  - 7)
    return float((np.abs(got - want32) / ulp).max())


@pytest.mark.parametrize("k", TILE_K)
@pytest.mark.parametrize("m", TILE_M)
@pytest.mark.parametrize("act", ["none", "gelu"])
def test_i8_bias_act_plain_matches_jax_at_tile_edges(act, m, k):
    """``quantize_rows_reference`` + ``gemm_i8_bias_act_reference`` at
    dropout 0 against ``int8_serving._dense_i8`` (none) and
    ``fused_ffn._dense_i8_f32`` (GELU's h): h bit for bit; the GELU output
    within one bf16 ulp (JAX's A&S erf against the exact one)."""
    rng = np.random.RandomState(100 * m + k)
    x = (rng.randn(m, k) * 0.5).astype(np.float32)
    w = (rng.randn(k, TILE_N) * 0.05).astype(np.float32)
    b = (rng.randn(TILE_N) * 0.02).astype(np.float32)
    jq, js = jquant.quantize_weight(jnp.asarray(w), axis_in=-2)
    q, ws = quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    xq, xs = quantize_rows_reference(torch.from_numpy(x))
    h, y = K.gemm_i8_bias_act_reference(
        xq, xs, kernel_layout(q), ws.reshape(-1), torch.from_numpy(b), act,
        save_h=True)
    jx, jb = jnp.asarray(x), jnp.asarray(b)[None]
    if act == "none":
        want_h = jax_dense_i8(jx, jq, js, jb, jnp.bfloat16)
        np.testing.assert_array_equal(_bf16_bits(y), _jax_bf16_bits(want_h))
    else:
        want_h = jffn._dense_i8_f32(jx, jq, js, jb).astype(jnp.bfloat16)
        want_g = jffn._gelu_f32(want_h.astype(jnp.float32))
        assert _bf16_ulps(y.float().numpy(), np.asarray(
            want_g.astype(jnp.bfloat16).astype(jnp.float32))) <= 1.0
    np.testing.assert_array_equal(_bf16_bits(h), _jax_bf16_bits(want_h))


@pytest.mark.parametrize("k", TILE_K)
@pytest.mark.parametrize("m", TILE_M)
@pytest.mark.parametrize("epilogue", ["dgelu", "residual", "none"])
def test_i8_dgrad_plain_matches_jax_at_tile_edges(epilogue, m, k):
    """``quantize_grad_rows_reference`` + ``gemm_i8_dgrad_reference`` at
    dropout 0 against ``fused_ffn._dgrad_rows_i8`` and the epilogue
    arithmetic of JAX's int8 backwards: the product d bit for bit, the
    residual (``ds + d``) and none outputs bit for bit after their bf16
    rounding; dgelu's ``d * gelu'(h)`` where JAX's A&S erf meets the
    exact one -- f32 dh within 1e-6 of its largest value and zero where
    JAX's is, bf16 dh and the regenerated gd within one bf16 ulp."""
    rng = np.random.RandomState(100 * m + k + 7)
    w = (rng.randn(TILE_N, k) * 0.05).astype(np.float32)   # (in, out)
    g = (rng.randn(m, k) * 1e-3).astype(np.float32)
    jq, js = jquant.quantize_weight(jnp.asarray(w), axis_in=-2)
    _, wr, ws = quantize_train_weight(torch.from_numpy(w))
    want_d = jffn._dgrad_rows_i8(jnp.asarray(g), jq, js)
    gq, gs = K.quantize_grad_rows_reference(torch.from_numpy(g), ws)
    d = K.gemm_i8_dgrad_reference(gq, gs, wr, "none",
                                  out_dtype=torch.float32)
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    if epilogue == "none":
        np.testing.assert_array_equal(
            _bf16_bits(K.gemm_i8_dgrad_reference(gq, gs, wr, "none")),
            _jax_bf16_bits(want_d.astype(jnp.bfloat16)))
    elif epilogue == "residual":
        ds = rng.randn(m, TILE_N).astype(np.float32)
        got = K.gemm_i8_dgrad_reference(gq, gs, wr, "residual",
                                        ds=torch.from_numpy(ds))
        np.testing.assert_array_equal(
            _bf16_bits(got),
            _jax_bf16_bits((jnp.asarray(ds) + want_d).astype(jnp.bfloat16)))
    else:
        h = torch.from_numpy(rng.randn(m, TILE_N).astype(np.float32)).to(
            torch.bfloat16)
        dh, dh32, gd = K.gemm_i8_dgrad_reference(gq, gs, wr, "dgelu", h=h)
        jh = jnp.asarray(h.float().numpy())
        want_dh = np.array(want_d * jffn._gelu_grad_f32(jh))
        want_gd = np.asarray(jffn._gelu_f32(jh).astype(jnp.bfloat16).astype(
            jnp.float32))
        np.testing.assert_array_equal(dh32.numpy() == 0, want_dh == 0)
        np.testing.assert_allclose(dh32.numpy(), want_dh, rtol=0,
                                   atol=1e-6 * np.abs(want_dh).max())
        nz = want_dh != 0
        want_dh16 = torch.from_numpy(want_dh).to(torch.bfloat16).float()
        assert _bf16_ulps(dh.float().numpy()[nz],
                          want_dh16.numpy()[nz]) <= 1.0
        assert _bf16_ulps(gd.float().numpy(), want_gd) <= 1.0


def test_weights_are_quantized_from_their_bf16_cast(monkeypatch):
    """In bf16 compute the encoder hands both int8 blocks the bf16 cast of
    the f32 master weights, and each block quantizes that cast (as JAX's
    ``_fwd_call_i8`` quantizes ``w.astype(f32)`` of it), not the master --
    which would give other int8 values."""
    from nbest_asr_tpu_torch.models.encoder import (EncoderConfig,
                                                    encoder_forward,
                                                    init_encoder_params)

    seen = []

    def spy(w):
        seen.append(w.detach().clone())
        return quantize_train_weight(w)

    monkeypatch.setattr(ff, "quantize_train_weight", spy)
    monkeypatch.setattr(fa, "quantize_train_weight", spy)
    cfg = EncoderConfig(vocab_size=50, hidden_size=H, num_layers=1,
                        num_heads=NH, intermediate_size=INTER,
                        max_position=32, compute_dtype="bfloat16",
                        use_fused_attn=True, use_fused_ffn=True,
                        use_int8_train=True, use_int8_train_attn=True)
    params = init_encoder_params(torch.Generator().manual_seed(0), cfg)
    ids = torch.randint(0, 50, (2, 16), generator=torch.Generator()
                        .manual_seed(1))
    encoder_forward(params, ids, torch.ones(2, 16), None, cfg,
                    deterministic=False, seed=3)
    lp = params["layers"]
    masters = [lp[k][0] for k in ("qkv_kernel", "attn_out_kernel",
                                  "ffn_in_kernel", "ffn_out_kernel")]
    assert len(seen) == 4
    for w, m in zip(seen, masters):
        assert w.dtype == torch.bfloat16
        assert torch.equal(w, m.to(torch.bfloat16))
        q_cast = quantize_weight(w.float())[0]
        assert not torch.equal(q_cast, quantize_weight(m)[0])


def test_bf16_backward_recomputes_h_as_jax_does():
    """With ``int8_bwd=False`` the FFN backward differentiates through h
    recomputed in the compute dtype from x, as JAX's ``_bwd_kernel`` does
    (fused_ffn.py:241-243), not through the int8 forward's h: the
    Function's dx, dW1, db1 and dW2 sit within ~1e-5 of JAX's, while the
    same backward fed the int8 forward's h (and the gd it regenerates)
    lands 100 times farther off."""
    args = _ffn_inputs(seed=3)
    _, want = _jax_grads(jax_ffn_i8, args, eps=EPS)
    _, grads = _torch_grads(ff.fused_ffn_block_int8_train, args)
    x2, w1, b1, w2, b2, ls, lb = (torch.from_numpy(a) for a in args)
    w1q, _, w1s = quantize_train_weight(w1)
    w2q, _, w2s = quantize_train_weight(w2)
    h8, gd = K.gemm_i8_bias_act(*K.quantize_rows(x2), w1q, w1s, b1, "gelu",
                                torch.float32, save_h=True)
    s, y2d = K.gemm_i8_bias_residual(*K.quantize_rows(gd), w2q, w2s, b2, x2,
                                     save_y2d=True)
    y, mean, rstd = K.layer_norm_rows(s, ls, lb, EPS, torch.float32, True)
    dy2, _, ds = K.ffn_bwd_rows(x2, y2d, 2 * y, ls, mean, rstd)
    dh8, gd8 = K.gemm_dgrad(dy2, w2, "dgelu", h=h8)
    through_h8 = (K.gemm_dgrad(dh8, w1, "residual", ds=ds), x2.t() @ dh8,
                  dh8.sum(0), gd8.t() @ dy2)
    for i, other in enumerate(through_h8):
        d_port = np.abs(grads[i].numpy() - want[i]).max()
        d_h8 = np.abs(other.numpy() - want[i]).max()
        assert d_port <= 1e-4 and d_h8 >= 100 * d_port, (FFN_NAMES[i],
                                                          d_port, d_h8)


def test_dropout_masks_and_determinism():
    """With dropout both routes are deterministic per seed, another seed
    draws other masks, the int8 forward drops exactly the bf16 block's
    stream-1 and stream-2 elements (its y2d is 0 where the stream-2 mask
    drops), and the int8-dgrad backward's regenerated gd is the forward's
    (zero exactly where stream 1 drops)."""
    args = _ffn_inputs(n=64, seed=5)
    kw = dict(dropout_rate=0.3, seed=17)
    for int8_bwd in (False, True):
        y1, g1 = _torch_grads(ff.fused_ffn_block_int8_train, args,
                              int8_bwd=int8_bwd, **kw)
        y2, g2 = _torch_grads(ff.fused_ffn_block_int8_train, args,
                              int8_bwd=int8_bwd, **kw)
        assert torch.equal(y1, y2)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))
        y3, _ = _torch_grads(ff.fused_ffn_block_int8_train, args,
                             int8_bwd=int8_bwd, dropout_rate=0.3, seed=18)
        assert not torch.equal(y1, y3)
    x2, w1, b1, w2, b2, ls, lb = (torch.from_numpy(a) for a in args)
    d1, d2 = (Dropout(17, 0.3, st) for st in (1, 2))
    w1q, _, w1s = quantize_train_weight(w1)
    w2q, w2r, w2s = quantize_train_weight(w2)
    h, gd = K.gemm_i8_bias_act(*K.quantize_rows(x2), w1q, w1s, b1, "gelu",
                               torch.float32, d1, True)
    _, y2d = K.gemm_i8_bias_residual(*K.quantize_rows(gd), w2q, w2s, b2, x2,
                                     d2, True)
    k1 = keep_mask(17, 1, 0, 64, INTER, 0.3)
    k2 = keep_mask(17, 2, 0, 64, H, 0.3)
    assert (gd[~k1] == 0).all() and (gd[k1] != 0).all()
    assert torch.equal(y2d == 0, ~k2)
    ds = torch.randn(64, H, generator=torch.Generator().manual_seed(2))
    gq, gs = K.quantize_grad_rows(ds, w2s, d2)
    assert (gq[~k2] == 0).all()
    _, dh32, gd_b = K.gemm_i8_dgrad(gq, gs, w2r, "dgelu", h=h, drop=d1,
                                    out_dtype=torch.float32)
    assert torch.equal(gd_b, gd)
    assert (dh32[~k1] == 0).all()


def test_int8_ffn_refuses_the_streaming_f32_layout():
    """JAX's int8 FFN takes only the whole-weight layout, which f32 lacks
    at inter = 3072 (fused_ffn.py:658-662); the port raises alike."""
    x, _, _, _, b2, ls, lb = (torch.from_numpy(a) for a in _ffn_inputs())
    big1, big2 = torch.zeros(H, 3072), torch.zeros(3072, H)
    with pytest.raises(ValueError, match="non-streaming"):
        ff.fused_ffn_block_int8_train(x, big1, torch.zeros(3072), big2, b2,
                                      ls, lb, eps=EPS)
