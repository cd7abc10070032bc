"""The head dims the chunked attention family serves (``ops/kernels.py``:
``chunked_head_dim``, d > 256 or d % 8 != 0) against the JAX package on
the CPU: the same inputs, made with numpy from a seed, through JAX's
functions under ``pltpu.force_tpu_interpret_mode()`` and the port's
(whose kernel wrappers run their plain versions on CPU tensors).

- flash attention's single-block route at d = 12 (the CLI's ``--n_head
  64`` at hidden 768), 3 (a head off every 4-byte boundary) and 320 (JAX's
  own hidden 640 x 2 heads), s = 100 and 200, forward and gradients;
- its tiled route (``block_q = block_k = 128`` at s = 256, as
  ``tests/test_torch_flash_attention.py`` forces it) at d = 12 and 320;
- the attention block's three kernel routes at hidden 640 x 2 heads (d
  = 320): ``fused_attention_block`` and ``fused_attention_block_int8_train``
  (both backwards), forward and all seven gradients, and the int8 serving
  ``int8_attention_block``;
- the encoder at BERT-base width on JAX's megakernel route, 2 heads of
  384 and 1 head of 768: the eval forward, and in training (dropout 0) the
  forward and every parameter's gradient.

Tolerances: flash attention's f32 ``FWD_TOL`` / ``GRAD_TOL`` of
``tests/test_torch_flash_attention.py``; the blocks their own files':
``tests/test_torch_attn_train.py`` (forward 2e-5 / 1e-4, gradients 5e-4 /
2e-3), ``tests/test_torch_int8_train.py`` (forward 3e-5 / 1e-4, gradients
5e-4 / 5e-3 and with the int8 backward 2e-3 / 1e-2) and
``tests/test_torch_int8_serving.py`` (3e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nbest_asr_tpu.models import encoder as j_enc
from nbest_asr_tpu.ops import flash_attention as j_flash
from nbest_asr_tpu.ops import int8_serving as ji8
from nbest_asr_tpu.ops import quant as jq
from nbest_asr_tpu.ops.fused_attention import \
    fused_attention_block as j_fab
from nbest_asr_tpu.ops.fused_attention import \
    fused_attention_block_int8_train as j_fab_i8
from nbest_asr_tpu_torch.models import encoder as t_enc
from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.ops import flash_attention as t_flash
from nbest_asr_tpu_torch.ops import fused_attention as t_fa
from nbest_asr_tpu_torch.ops import int8_serving as ti8
from nbest_asr_tpu_torch.ops import kernels as K
from nbest_asr_tpu_torch.ops import quant as tq
from nbest_asr_tpu_torch.params_bridge import from_jax_numpy

FWD_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)
# the attention blocks at JAX's hidden 640 x 2 heads
H, NH = 640, 2
EPS = 1e-12
NAMES = ("x", "wqkv", "bqkv", "wo", "bo", "ln_scale", "ln_bias")


def _no_launches():
    return all(v == 0 for v in _cuda.launch_counts.values())


def _flash_inputs(b, s, h, d, seed, packed=False):
    """q, k, v (b, s, h, d) f32 and a (b, s) mask: random valid lengths,
    or with ``packed`` three segments, then pads."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, s), np.float32)
    for i in range(b):
        n = rng.randint(s // 4, s + 1)
        if packed:
            cuts = np.sort(rng.choice(np.arange(1, n), 2, replace=False))
            mask[i, :cuts[0]], mask[i, cuts[0]:cuts[1]] = 1.0, 2.0
            mask[i, cuts[1]:n] = 3.0
        else:
            mask[i, :n] = 1.0
    return q, k, v, mask


def _hold_flash(arrays, **kw):
    """Flash attention's output and the gradients of sum(out^2) over the
    real tokens, JAX's against the port's."""
    q, k, v, mask = arrays
    valid = (mask > 0).astype(np.float32)[:, :, None, None]

    def loss(q, k, v):
        out = j_flash.flash_attention(q, k, v, jnp.asarray(mask), **kw)
        return jnp.sum(out ** 2 * valid), out

    with pltpu.force_tpu_interpret_mode():
        (_, jo), jg = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
            *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (q, k, v)]
    _cuda.reset_launch_counts()
    out = t_flash.flash_attention(*ts, torch.from_numpy(mask), **kw)
    (out ** 2 * torch.from_numpy(valid)).sum().backward()
    assert _no_launches()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               **FWD_TOL)
    for name, t, g in zip("qkv", ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("s", [100, 200])
@pytest.mark.parametrize("d,nh", [(12, 4), (3, 3), (320, 2)],
                         ids=["d12", "d3", "d320"])
def test_single_block_route_matches_jax(d, nh, s):
    """s <= 512, no block size: the port's single-block Function on the
    ``seg_attention`` pair, whose card kernels at these head dims are the
    chunked family; two rows at s = 100, one row of packed segments at s =
    200."""
    assert K.attn_instance(d, s) == K.attn_instance(d, s, True) == "chunked"
    _hold_flash(_flash_inputs(3 - s // 100, s, nh, d, seed=d + s,
                              packed=s == 200))


@pytest.mark.parametrize("d,nh", [(12, 4), (320, 2)], ids=["d12", "d320"])
def test_tiled_route_matches_jax(d, nh):
    """block_q = block_k = 128 forces both sides' tiled kernels, which run
    the chunked family on the card at these head dims; one row of packed
    segments."""
    assert K.chunked_head_dim(d)
    _hold_flash(_flash_inputs(1, 256, nh, d, seed=7 + d, packed=True),
                block_q=128, block_k=128)


def _block_inputs(b, s, seed, kind):
    """The attention block's seven operands (f32) and a padded or packed
    mask, at hidden H."""
    rng = np.random.RandomState(seed)
    args = [(rng.randn(b, s, H) * 0.5).astype(np.float32),
            (rng.randn(H, 3 * H) * 0.03).astype(np.float32),
            (rng.randn(3 * H) * 0.02).astype(np.float32),
            (rng.randn(H, H) * 0.03).astype(np.float32),
            (rng.randn(H) * 0.02).astype(np.float32),
            (1.0 + 0.1 * rng.randn(H)).astype(np.float32),
            (0.1 * rng.randn(H)).astype(np.float32)]
    mask = np.zeros((b, s), np.float32)
    for i in range(b):
        if kind == "padded":
            mask[i, :rng.randint(s // 2, s + 1)] = 1.0
        else:
            c = np.sort(rng.choice(np.arange(1, s), size=3, replace=False))
            mask[i, :c[0]], mask[i, c[0]:c[1]], mask[i, c[1]:c[2]] = 1, 2, 3
    mask[:, 0] = np.maximum(mask[:, 0], 1.0)
    return args, mask


def _hold_block(j_fn, t_fn, args, mask, fwd_tol, grad_tol, **kw):
    def loss(*a):
        return jnp.sum(j_fn(*a, jnp.asarray(mask), n_heads=NH, eps=EPS,
                            **kw) ** 2)

    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        ja = [jnp.asarray(a) for a in args]
        want_y = np.asarray(j_fn(*ja, jnp.asarray(mask), n_heads=NH,
                                 eps=EPS, **kw))
        want_g = jax.grad(loss, argnums=tuple(range(7)))(*ja)
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    _cuda.reset_launch_counts()
    y = t_fn(*ts, torch.from_numpy(mask), n_heads=NH, eps=EPS, **kw)
    (y * y).sum().backward()
    assert _no_launches()
    np.testing.assert_allclose(y.detach().numpy(), want_y, **fwd_tol)
    for t, w, name in zip(ts, want_g, NAMES):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **grad_tol)


@pytest.mark.parametrize("kind", ["padded", "packed"])
def test_fused_attention_block_at_d320_matches_pallas(kind):
    """JAX's attention megakernel route (hidden % 128 == 0, d % 64 == 0)
    at d = 320, where the port's block runs the chunked single-block pair
    on the card."""
    args, mask = _block_inputs(2, 40, seed=31, kind=kind)
    _hold_block(j_fab, t_fa.fused_attention_block, args, mask,
                dict(atol=2e-5, rtol=1e-4), dict(atol=5e-4, rtol=2e-3))


@pytest.mark.parametrize("int8_bwd", [False, True],
                         ids=["bf16_bwd", "int8_bwd"])
def test_int8_train_attention_block_at_d320_matches_pallas(int8_bwd):
    args, mask = _block_inputs(2, 32, seed=41 + int8_bwd, kind="packed")
    grad_tol = (dict(atol=2e-3, rtol=1e-2) if int8_bwd
                else dict(atol=5e-4, rtol=5e-3))
    _hold_block(j_fab_i8, t_fa.fused_attention_block_int8_train, args,
                mask, dict(atol=3e-5, rtol=1e-4), grad_tol,
                int8_bwd=int8_bwd)


def test_int8_serving_attention_block_at_d320_matches_pallas():
    rng = np.random.RandomState(51)
    b, s = 3, 24
    x = (rng.randn(b, s, H) * 0.5).astype(np.float32)

    def quant(shape):
        q, sc = jq.quantize_weight(jnp.asarray(
            rng.randn(*shape).astype(np.float32) * 0.03))
        return q, sc, tq.kernel_layout(torch.from_numpy(np.array(q))), \
            torch.from_numpy(np.array(sc))

    wqkv, wo = quant((H, 3 * H)), quant((H, H))
    bqkv, bo, lb = (0.1 * rng.randn(n).astype(np.float32)
                    for n in (3 * H, H, H))
    ls = (1.0 + 0.1 * rng.randn(H)).astype(np.float32)
    mask = np.ones((b, s), np.float32)
    mask[0, 17:], mask[2, 5:] = 0.0, 0.0
    want = np.asarray(ji8.int8_attention_block(
        jnp.asarray(x), wqkv[0], wqkv[1], bqkv, wo[0], wo[1], bo, ls, lb,
        jnp.asarray(mask), n_heads=NH, interpret=True))
    _cuda.reset_launch_counts()
    got = ti8.int8_attention_block(
        *(torch.from_numpy(a) for a in (x,)), wqkv[2], wqkv[3],
        torch.from_numpy(bqkv), wo[2], wo[3], torch.from_numpy(bo),
        torch.from_numpy(ls), torch.from_numpy(lb), torch.from_numpy(mask),
        n_heads=NH).numpy()
    assert _no_launches()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("nh", [2, 1], ids=["d384", "d768"])
def test_encoder_at_bert_width_matches_jax(nh):
    """Hidden 768, one layer, JAX's megakernel route (``use_fused_attn``,
    ``use_fused_ffn``, and ``use_fused_attn_eval`` in eval) at 2 heads of
    384 and 1 head of 768, whose attention the port runs on the chunked
    family on the card: the eval forward, and in training at dropout 0
    the forward and the gradient of sum(out^2) for every parameter;
    tolerances of ``tests/test_torch_attn_train.py``."""
    kw = dict(vocab_size=50, hidden_size=768, num_heads=nh,
              intermediate_size=256, num_layers=1, max_position=32,
              hidden_dropout=0.0, attn_dropout=0.0, use_fused_attn=True,
              use_fused_ffn=True, use_fused_attn_eval=True)
    jcfg, tcfg = j_enc.EncoderConfig(**kw), t_enc.EncoderConfig(**kw)
    rng = np.random.RandomState(nh)
    ids = rng.randint(1, 50, (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.float32)
    mask[1, 15:] = 0.0
    jparams = jax.device_get(j_enc.init_encoder_params(
        jax.random.PRNGKey(nh), jcfg))

    def jloss(p):
        out = j_enc.encoder_forward(p, jnp.asarray(ids), jnp.asarray(mask),
                                    None, jcfg, deterministic=False,
                                    rng=jax.random.PRNGKey(0))
        return jnp.sum(out ** 2), out

    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        j_eval = np.asarray(j_enc.encoder_forward(
            jparams, jnp.asarray(ids), jnp.asarray(mask), None, jcfg))
        (_, j_train), j_grads = jax.value_and_grad(jloss, has_aux=True)(
            jparams)
    tparams = from_jax_numpy(jparams)
    leaves = {f"{g}/{k}": v for g in tparams for k, v in tparams[g].items()}
    for v in leaves.values():
        v.requires_grad_(True)
    _cuda.reset_launch_counts()
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        t_eval = t_enc.encoder_forward(tparams, t_ids, t_mask, None, tcfg)
    t_train = t_enc.encoder_forward(tparams, t_ids, t_mask, None, tcfg,
                                    deterministic=False, seed=1)
    (t_train ** 2).sum().backward()
    assert _no_launches()
    np.testing.assert_allclose(t_eval.numpy(), j_eval, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(t_train.detach().numpy(), np.asarray(j_train),
                               atol=2e-5, rtol=1e-4)
    for name, v in leaves.items():
        g, k = name.split("/")
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(j_grads[g][k]),
                                   atol=5e-4, rtol=2e-3, err_msg=name)
