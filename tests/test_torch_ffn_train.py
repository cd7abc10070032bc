"""The port's FFN block for training (``ops/fused_ffn.py``: the autograd
Function over the forward and backward kernel chains; on the CPU their
plain versions) against the JAX ``fused_ffn_block`` run under
``pltpu.force_tpu_interpret_mode()``, as ``tests/test_fused_ffn.py`` runs
it, at the sizes and tolerances of that test: forward 2e-5 / 1e-4, all
seven gradients 5e-4 / 2e-3 (f32; the Pallas side's A&S erf and the
summation orders differ).  The JAX interpret-mode PRNG is all zeros, so
dropout is never compared with JAX: with dropout the Function is held to
torch autograd through ``fused_ffn_block_reference`` on the same Philox
masks, and the backward's regenerated masks to the forward's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nbest_asr_tpu.ops.fused_ffn import fused_ffn_block as jax_ffn
from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.ops import kernels as K
from nbest_asr_tpu_torch.ops.fused_ffn import (fused_ffn_block,
                                               fused_ffn_block_reference)
from nbest_asr_tpu_torch.ops.philox import keep_mask, site

H, INTER = 128, 256
EPS = 1e-12
NAMES = ("x", "w1", "b1", "w2", "b2", "ln_scale", "ln_bias")


def _inputs(shape=(48,), seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape, H) * 0.5).astype(np.float32),
            (rng.randn(H, INTER) * 0.05).astype(np.float32),
            (rng.randn(INTER) * 0.02).astype(np.float32),
            (rng.randn(INTER, H) * 0.05).astype(np.float32),
            (rng.randn(H) * 0.02).astype(np.float32),
            (1.0 + 0.1 * rng.randn(H)).astype(np.float32),
            (0.1 * rng.randn(H)).astype(np.float32)]


def _torch_grads(fn, args, **kw):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    y = fn(*ts, eps=EPS, **kw)
    (y * y).sum().backward()
    return y.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("shape", [(48,), (3, 24)])
def test_forward_and_all_gradients_match_pallas(shape):
    args = _inputs(shape)

    def loss(*a):
        out = jax_ffn(*a, eps=EPS)
        return jnp.sum(out * out)

    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        ja = [jnp.asarray(a) for a in args]
        want_y = np.asarray(jax_ffn(*ja, eps=EPS))
        want_g = jax.grad(loss, argnums=tuple(range(7)))(*ja)
    _cuda.reset_launch_counts()
    y, grads = _torch_grads(fused_ffn_block, args)
    assert all(v == 0 for v in _cuda.launch_counts.values())
    np.testing.assert_allclose(y.numpy(), want_y, atol=2e-5, rtol=1e-4)
    for g, w, name in zip(grads, want_g, NAMES):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=2e-3, err_msg=f"d{name}")


def test_dropout_gradients_match_autograd_of_plain_block():
    args = _inputs()
    y, grads = _torch_grads(fused_ffn_block, args, dropout_rate=0.25,
                            seed=11)
    ry, rgrads = _torch_grads(fused_ffn_block_reference, args,
                              dropout_rate=0.25, seed=11)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), atol=1e-5)
    for g, r, name in zip(grads, rgrads, NAMES):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")
    # another seed draws other masks
    y2, _ = _torch_grads(fused_ffn_block, args, dropout_rate=0.25, seed=12)
    assert not torch.equal(y, y2)


def test_backward_regenerates_the_forward_masks():
    x, w1, b1, w2, b2, ls, lb = (torch.from_numpy(a) for a in _inputs())
    n = x.shape[0]
    d1, d2 = site(21, 0.25, 1), site(21, 0.25, 2)
    h, gd = K.gemm_bias_act(x, w1, b1, "gelu", drop=d1, save_h=True)
    s, y2d = K.gemm_bias_residual(gd, w2, b2, x, drop=d2, save_y2d=True)
    _, mean, rstd = K.layer_norm_rows(s, ls, lb, EPS, x.dtype, stats=True)
    dy = torch.randn(n, H, generator=torch.Generator().manual_seed(0))
    dy2, _, _ = K.ffn_bwd_rows(x, y2d, dy, ls, mean, rstd, drop=d2)
    _, gd_bwd = K.gemm_dgrad(dy2, w2, "dgelu", h=h, drop=d1)
    assert torch.equal(gd_bwd, gd)
    k1 = keep_mask(21, 1, 0, n, INTER, 0.25)
    k2 = keep_mask(21, 2, 0, n, H, 0.25)
    assert (gd[~k1] == 0).all() and (gd[k1] != 0).all()
    assert torch.equal(y2d == 0, ~k2) and torch.equal(dy2 == 0, ~k2)
    for k in (k1, k2):
        assert abs(k.float().mean().item() - 0.75) <= \
            4 * np.sqrt(0.25 * 0.75 / k.numel())


def test_dropout_needs_a_seed():
    x, w1, b1, w2, b2, ls, lb = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="seed"):
        fused_ffn_block(x, w1, b1, w2, b2, ls, lb, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_rate"):
        fused_ffn_block(x, w1, b1, w2, b2, ls, lb, dropout_rate=1.0,
                        seed=1)
