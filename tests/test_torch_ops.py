"""The port's plain ops against the JAX package's on the same inputs:
``dense``, ``gelu``, ``layer_norm`` and the XLA branch of
``multi_head_attention`` with 1/0 padding and packed segment masks.

f32 throughout, atol 1e-5: both sides run the same f32 algorithm and
differ only in summation order and transcendental implementations
(ulp-level, well under 1e-5 at these magnitudes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbest_asr_tpu.ops import attention as jattn
from nbest_asr_tpu.ops import layers as jlayers
from nbest_asr_tpu_torch.ops import attention as tattn
from nbest_asr_tpu_torch.ops import layers as tlayers

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_dense_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 32).astype(np.float32)
    w = (rng.randn(32, 48) * 0.1).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    want = np.asarray(jlayers.dense(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b)))
    got = tlayers.dense(_t(x), _t(w), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_gelu_matches_jax():
    x = np.linspace(-6.0, 6.0, 1001, dtype=np.float32)
    want = np.asarray(jlayers.gelu(jnp.asarray(x)))
    got = tlayers.gelu(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_layer_norm_matches_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 5, 64) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    bias = (0.1 * rng.randn(64)).astype(np.float32)
    want = np.asarray(jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                         jnp.asarray(bias), 1e-12))
    got = tlayers.layer_norm(_t(x), _t(scale), _t(bias), 1e-12).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _padded_mask(rng, b, s):
    m = (rng.rand(b, s) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    return m


def _packed_mask(rng, b, s):
    """Rows of 1-3 packed segments (ids 1, 2, 3) followed by pads."""
    m = np.zeros((b, s), np.float32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), size=3, replace=False))
        m[i, :cuts[0]] = 1
        m[i, cuts[0]:cuts[1]] = 2
        m[i, cuts[1]:cuts[2]] = 3
    return m


@pytest.mark.parametrize("kind", ["padded", "packed"])
def test_multi_head_attention_matches_jax_xla_branch(kind):
    rng = np.random.RandomState(2 if kind == "padded" else 3)
    b, s, nh, d = 3, 19, 4, 16
    q, k, v = (rng.randn(b, s, nh, d).astype(np.float32) for _ in range(3))
    mask = (_padded_mask if kind == "padded" else _packed_mask)(rng, b, s)
    want = np.asarray(jattn.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        deterministic=True))
    got = tattn.multi_head_attention(_t(q), _t(k), _t(v), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
