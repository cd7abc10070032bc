"""The port's ``ops/flash_attention.py`` against the JAX package's on the
CPU: the same inputs, made with numpy from a seed, through JAX's
``flash_attention`` under ``pltpu.force_tpu_interpret_mode()`` and the
port's (whose kernels run their plain versions on CPU tensors).  Both
routes: single-block (s <= 512, no block size) and tiled (a block size
given, or s > 512).

Head dims: 64, 32, and those the port's kernels take beside them -- 96
(the quality tools' 768 / 8 heads), 192 (the CLI's 768 / 4 heads) and 48,
which the card pads to its 64-wide instance -- on both routes.

Tolerances are the JAX package's own flash tests' (tests/
test_flash_attention.py): f32 forward atol 2e-5 / rtol 1e-4, f32
gradients atol 5e-4 / rtol 1e-3, bf16 outputs within 0.05.  JAX's TPU
dropout bits cannot be reproduced, so parity is held at dropout 0; with
dropout the port's own routes are held to one another (one Philox mask
per seed and element, regenerated by the backward)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nbest_asr_tpu.ops import attention as j_attention
from nbest_asr_tpu.ops import flash_attention as j_flash
from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.ops import kernels as K
from nbest_asr_tpu_torch.ops import attention as t_attention
from nbest_asr_tpu_torch.ops import flash_attention as t_flash
from nbest_asr_tpu_torch.ops.philox import keep_mask, site

FWD_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)


def _inputs(b, s, h, d, seed, packed=False):
    """q, k, v (b, s, h, d) f32 and a (b, s) mask: random valid lengths
    (s // 4 .. s), or with ``packed`` up to three segments, then pads."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, s), np.float32)
    for i in range(b):
        n = rng.randint(s // 4, s + 1)
        if packed:
            cuts = np.sort(rng.choice(np.arange(1, n), 2, replace=False))
            mask[i, :cuts[0]] = 1.0
            mask[i, cuts[0]:cuts[1]] = 2.0
            mask[i, cuts[1]:n] = 3.0
        else:
            mask[i, :n] = 1.0
    return q, k, v, mask


def _jax_out_and_grads(arrays, dtype=jnp.float32, **kw):
    q, k, v, mask = (jnp.asarray(a) for a in arrays)
    q, k, v = (t.astype(dtype) for t in (q, k, v))
    valid = (mask > 0).astype(jnp.float32)[:, :, None, None]

    def loss(q, k, v):
        out = j_flash.flash_attention(q, k, v, mask, **kw)
        return jnp.sum(out.astype(jnp.float32) ** 2 * valid), out

    with pltpu.force_tpu_interpret_mode():
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(q, k, v)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32)
                                         for g in grads]


def _port_out_and_grads(arrays, dtype=torch.float32, **kw):
    q, k, v, mask = (torch.from_numpy(a) for a in arrays)
    q, k, v = (t.to(dtype).requires_grad_(True) for t in (q, k, v))
    valid = (mask > 0).float()[:, :, None, None]
    out = t_flash.flash_attention(q, k, v, mask, **kw)
    (out.float() ** 2 * valid).sum().backward()
    return out.detach().float().numpy(), [t.grad.float().numpy()
                                          for t in (q, k, v)]


def _hold(arrays, fwd_only=False, **kw):
    jo, jg = _jax_out_and_grads(arrays, **kw)
    _cuda.reset_launch_counts()
    to, tg = _port_out_and_grads(arrays, **kw)
    assert all(v == 0 for v in _cuda.launch_counts.values())
    np.testing.assert_allclose(to, jo, **FWD_TOL)
    if not fwd_only:
        for name, a, b in zip("qkv", tg, jg):
            np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("s", [256, 200])
def test_single_block_forward_matches_jax(s):
    _hold(_inputs(2, s, 4, 64, seed=0), fwd_only=True)


@pytest.mark.parametrize("s,d,packed", [
    pytest.param(s, d, False, id=f"{s}-{d}")
    for s, d in ((128, 64), (100, 32), (160, 96), (100, 48), (64, 192),
                 (300, 192))] + [pytest.param(512, 192, True,
                                              id="512-192-packed")])
def test_single_block_gradients_match_jax(s, d, packed):
    """s = 100: JAX pads q rows to 112 and kv rows to 128 with mask -1;
    the port pads nothing.  d = 192 past 256 keys (the card's streaming
    wgmma pair): s = 300 padded, s = 512 packed."""
    _hold(_inputs(2, s, 2, d, seed=1, packed=packed))


def test_packed_masks_match_jax():
    _hold(_inputs(3, 96, 2, 64, seed=2, packed=True))


@pytest.mark.parametrize("s,d", [pytest.param(256, 64, id="256"),
                                 pytest.param(640, 64, id="640"),
                                 pytest.param(256, 96, id="256-d96"),
                                 pytest.param(700, 96, id="700-d96"),
                                 pytest.param(128, 192, id="128-d192")])
def test_tiled_route_matches_jax(s, d):
    """block_q = block_k = 128 forces JAX's tiled kernels (and the port's
    tiled route); s = 640 also pads JAX's tiles to 768.  s = 700 at d = 96
    (the quality tools' head dim, whose tiled backward pair runs on wgmma
    on the card) is no multiple of 64 or 128: JAX pads it to 768, the port
    pads nothing; packed masks at 256 and 700.  FWD_TOL / GRAD_TOL, f32."""
    _hold(_inputs(2, s, 2, d, seed=3, packed=s in (256, 700)), block_q=128,
          block_k=128)


def test_bf16_inputs_match_jax():
    arrays = _inputs(2, 128, 4, 64, seed=4)
    jo, _ = _jax_out_and_grads(arrays, dtype=jnp.bfloat16)
    to, tg = _port_out_and_grads(arrays, dtype=torch.bfloat16)
    assert np.abs(to - jo).max() < 0.05
    to_t, tg_t = _port_out_and_grads(arrays, dtype=torch.bfloat16,
                                     block_q=128)
    assert np.abs(to_t - jo).max() < 0.05
    for a, b in zip(tg, tg_t):          # the routes' bf16 gradients agree
        assert np.abs(a - b).max() <= 0.05 * np.abs(b).max()


def test_dropout_requires_a_seed():
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(1, 8, 1, 32, 5))
    with pytest.raises(ValueError, match="seed"):
        t_flash.flash_attention(q, k, v, mask, dropout_rate=0.1)


def test_dropout_one_mask_for_both_routes_and_the_backward():
    """Four packed segments of 16 and one-hot v within each segment (v[k]
    = e_{k mod 16}, d = 16): o[q, c] is then the dropped prob of key 16
    seg(q) + c, and with do[q] = e_{q mod 16} dv[k, c] is the dropped prob
    of query 16 seg(k) + c -- so o != 0 and dv != 0 show the forward's
    and the backward's masks.  Both equal the Philox stream-3 keep mask
    on the diagonal blocks, on both routes; the routes' dq agree; the
    keep rate is 1 - rate within 4 sigma."""
    b, s, h, d, rate, seed = 2, 64, 2, 16, 0.3, 1234
    rng = np.random.RandomState(6)
    q, k = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
            for _ in range(2))
    eye = torch.eye(d)
    v = eye.repeat(s // d, 1)[None, :, None, :].expand(b, s, h, d).clone()
    do = v.clone()
    mask = (torch.arange(s) // d + 1).float()[None].expand(b, s).clone()
    keep = keep_mask(seed, 3, 0, b * h * s, s, rate).reshape(b, h, s, s)
    seg = torch.arange(s) // d
    diag = seg[:, None] == seg[None, :]
    want = keep & diag                              # (b, h, q, k)
    grads = []
    for kw in ({}, dict(block_q=16, block_k=16)):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        o = t_flash.flash_attention(qq, kk, vv, mask, dropout_rate=rate,
                                    seed=seed, **kw)
        o.backward(do)
        # o[b, q, h, c] -> prob (q, key 16 seg(q) + c)
        got_fwd = torch.zeros(b, h, s, s, dtype=torch.bool)
        got_bwd = torch.zeros(b, h, s, s, dtype=torch.bool)
        for c in range(d):
            qs = torch.arange(s)
            ks = seg * d + c
            got_fwd[:, :, qs, ks] = (o[:, qs, :, c] != 0).permute(0, 2, 1)
            # dv[b, key, h, c] -> prob (query 16 seg(key) + c, key)
            got_bwd[:, :, ks, qs] = (vv.grad[:, qs, :, c] != 0).permute(
                0, 2, 1)
        assert torch.equal(got_fwd, want)
        assert torch.equal(got_bwd, want)
        grads.append(qq.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-5)
    # the routes' plain backwards, side by side, from the same seed
    drop = site(seed, rate, 3)
    o, st = K.sb_attention_reference(q, k, v, mask, 0.25, drop, stats=True)
    to, lse = K.flash_fwd_reference(q, k, v, mask, 0.25, drop)
    torch.testing.assert_close(to, o, rtol=1e-5, atol=1e-6)
    for a, b_ in zip(K.flash_bwd_reference(q, k, v, mask, to, lse, do, 0.25,
                                           drop),
                     K.sb_attention_bwd_reference(q, k, v, do, mask, st,
                                                  0.25, drop)):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-5)
    n = keep.numel()
    assert abs(keep.float().mean().item() - (1 - rate)) <= 4 * (
        rate * (1 - rate) / n) ** 0.5


def test_views_of_one_qkv_buffer_are_read_in_place():
    """The encoder's split views of its (b, s, 3h) QKV buffer share one
    row stride, so the route takes them without copies; mixed layouts
    are made contiguous."""
    qkv = torch.randn(2, 10, 3 * 64)
    q, k, v = (t.reshape(2, 10, 2, 32) for t in qkv.split(64, dim=-1))
    got = t_flash._shared_rows(q, k, v)
    assert all(a is b for a, b in zip(got, (q, k, v)))
    got = t_flash._shared_rows(q, k.contiguous(), v)
    assert all(t.is_contiguous() for t in got)


# --------------------------------------------------------------------- #
# routing: JAX's predicate and multi_head_attention, to the letter
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("itemsize", [2, 4])
def test_flash_preferred_matches_jax(itemsize):
    for b in (1, 8, 28, 29, 32, 64):
        for s in (64, 160, 512, 513, 768, 1024, 2048):
            for nh in (2, 12):
                assert (t_attention._flash_preferred(b, s, nh, itemsize)
                        == j_attention._flash_preferred(b, s, nh, itemsize))


@pytest.mark.parametrize("env", [None, "64", "100000"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_multi_head_attention_routes_as_jax(monkeypatch, env, dtype):
    """Over (batch, seq, deterministic, use_flash, flash_min_seq) the port
    calls its flash_attention exactly where JAX calls its own, with the
    env override read at each call (shapes only: JAX traced by
    eval_shape, the port on meta tensors; the rate does not route)."""
    if env is None:
        monkeypatch.delenv("NBEST_FLASH_MIN_SEQ", raising=False)
    else:
        monkeypatch.setenv("NBEST_FLASH_MIN_SEQ", env)
    calls = []

    def fake(q, *a, **kw):
        calls.append(q.shape)
        return q

    monkeypatch.setattr(j_flash, "flash_attention", fake)
    monkeypatch.setattr(t_flash, "flash_attention", fake)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    nh, d = 12, 8
    for b, s in ((32, 64), (32, 96), (48, 160), (32, 256), (8, 1024),
                 (32, 1024)):
        spec = jax.ShapeDtypeStruct((b, s, nh, d), jdt)
        mspec = jax.ShapeDtypeStruct((b, s), jnp.float32)
        t = torch.empty((b, s, nh, d), dtype=tdt, device="meta")
        tm = torch.empty((b, s), device="meta")
        for det in (True, False):
            for use_flash in (True, False):
                for fms in (None, 96, 256):
                    kw = dict(deterministic=det, use_flash=use_flash,
                              flash_min_seq=fms)
                    calls.clear()
                    jax.eval_shape(
                        lambda q, k, v, m: j_attention.multi_head_attention(
                            q, k, v, m, **kw), spec, spec, spec, mspec)
                    j_took = len(calls)
                    calls.clear()
                    t_attention.multi_head_attention(t, t, t, tm, **kw)
                    assert j_took == len(calls) <= 1, (b, s, det, use_flash,
                                                       fms)
                    assert len(calls) == t_attention.flash_routes(
                        t.shape, t.element_size(), **kw)


@pytest.mark.parametrize("flags,seq,calls", [
    (dict(use_flash_attention=True, flash_min_seq=16), 24, 2),
    (dict(use_flash_attention=True, flash_min_seq=32), 24, 0),
    (dict(use_flash_attention=False, flash_min_seq=16), 24, 0),
    # the attention megakernel takes the layer (hidden 128, head dim 64)
    (dict(use_flash_attention=True, flash_min_seq=16, use_fused_attn=True),
     24, 0),
    # head dim 32 fails its lane rule: flash, as in JAX
    (dict(use_flash_attention=True, flash_min_seq=16, use_fused_attn=True,
          num_heads=4), 24, 2),
    # head dim 96 (the quality tools' geometry) fails it too
    (dict(use_flash_attention=True, flash_min_seq=16, use_fused_attn=True,
          hidden_size=192), 24, 2),
    # head dim 192 with the megakernel off (the CLI's --no_fused_attn)
    (dict(use_flash_attention=True, flash_min_seq=16, hidden_size=384),
     24, 2),
], ids=["routes", "below_min_seq", "flag_off", "megakernel", "d32", "d96",
        "d192"])
def test_encoder_trains_through_flash_where_jax_does(monkeypatch, flags, seq,
                                                     calls):
    """Two training layers call ``flash_attention`` once each exactly where
    JAX's encoder takes its flash kernels; eval never does."""
    from nbest_asr_tpu_torch.models.encoder import (EncoderConfig,
                                                    encoder_forward,
                                                    init_encoder_params)

    seen = []
    real = t_flash.flash_attention

    def counting(*a, **kw):
        seen.append(kw.get("seed"))
        return real(*a, **kw)

    monkeypatch.setattr(t_flash, "flash_attention", counting)
    cfg = EncoderConfig.tiny(50, **dict(dict(hidden_size=128, num_heads=2,
                                             intermediate_size=256), **flags))
    params = init_encoder_params(torch.Generator().manual_seed(0), cfg)
    ids = torch.randint(1, 50, (3, seq), generator=torch.Generator()
                        .manual_seed(1))
    mask = torch.ones(3, seq)
    for det in (True, False):
        seen.clear()
        encoder_forward(params, ids, mask, None, cfg, deterministic=det,
                        seed=None if det else 9)
        assert len(seen) == (0 if det else calls)
    assert len(set(seen)) == len(seen)     # one prob-mask seed per layer


def test_one_head_dim_predicate_decides_every_refusal():
    """For every head dim 1 .. 800 the kernel wrappers' checks (the (n,
    3h) buffer's and the (b, s, heads, d) operands') pass, the encoder
    raises nothing on the megakernel route in eval nor on the flash route
    in training, and ``chunked_head_dim`` -- which sends a head dim to the
    chunked family -- holds exactly at d > 256 or d % 8 != 0."""
    from nbest_asr_tpu_torch.models import encoder as E

    mask = torch.ones(1, 2)
    chunked = []
    for d in range(1, 801):
        qkv = torch.zeros(2, 3 * d, dtype=torch.bfloat16)
        q = torch.zeros(1, 2, 1, d, dtype=torch.bfloat16)
        assert K._attn_dims("seg_attention", qkv, mask, 1) == (1, 2, d)
        assert K._bshd("flash_fwd", q, q, q, mask)[3] == d
        assert K.chunked_head_dim(d) == (d > 256 or d % 8 != 0)
        chunked.append(K.chunked_head_dim(d))
    assert sum(chunked) == 800 - 32
    # the encoder at head dims the port once refused: 2 heads of 12 on
    # the flash route in training (d % 8 != 0), 1 head of 320 on the
    # megakernel route in eval and of 264 on the flash route in training
    ids = torch.randint(1, 50, (2, 24), generator=torch.Generator()
                        .manual_seed(0))
    for d, nh, train, flags in (
            (12, 2, True, dict(use_flash_attention=True, flash_min_seq=16)),
            (320, 1, False, dict(use_fused_attn=True,
                                 use_fused_attn_eval=True)),
            (264, 1, True, dict(use_flash_attention=True,
                                flash_min_seq=16))):
        cfg = E.EncoderConfig.tiny(50, hidden_size=d * nh, num_heads=nh,
                                   intermediate_size=64, **flags)
        params = E.init_encoder_params(torch.Generator().manual_seed(d),
                                       cfg)
        out = E.encoder_forward(params, ids, torch.ones(2, 24), None, cfg,
                                deterministic=not train,
                                seed=3 if train else None)
        assert out.shape == (2, 24, d * nh) and torch.isfinite(out).all()