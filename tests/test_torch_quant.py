"""The port's int8 oracles (``nbest_asr_tpu_torch/ops/quant.py``) and the
CPU side of the int8 kernel wrappers against the JAX package's
``ops/quant.py`` and ``ops/int8_serving.py:_quant_rows`` on the same
seeded inputs.

Quantization is bit-equal: both sides take the same abs-max, divide in
IEEE f32, round half to even and clip to [-127, 127].  The dense is held
at 1e-6 relative in f32 (the integer dot is exact on both sides; what
remains is the order of XLA's and torch's f32 epilogue operations, which
is the same) and at one bf16 ulp in bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbest_asr_tpu.ops import quant as jq
from nbest_asr_tpu.ops.int8_serving import _quant_rows
from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.ops import kernels as K
from nbest_asr_tpu_torch.ops import quant as tq
from nbest_asr_tpu_torch.params_bridge import from_jax_numpy


@pytest.mark.parametrize("shape", [(128, 384), (256, 128), (2, 128, 384),
                                   (3, 64, 64)])
def test_quantize_weight_bit_equal(shape):
    rng = np.random.RandomState(sum(shape))
    w = (rng.randn(*shape) * 0.05).astype(np.float32)
    w[..., 0, 3] = 0.0                      # a column with a zero entry
    if len(shape) == 2:
        w[:, 5] = 0.0                       # an all-zero column: 1e-12 floor
    jqv, jsv = jq.quantize_weight(jnp.asarray(w))
    q, s = tq.quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == tuple(np.asarray(jsv).shape)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_reference_bit_equal(dtype):
    rng = np.random.RandomState(3)
    x = (rng.randn(61, 256) * 0.7).astype(np.float32)
    x[4] = 0.0                              # all-zero row
    # a value that lands exactly on the .5 rounding boundary: amax 127
    # gives scale 1, so 2.5 -> 2 and 3.5 -> 4 (half to even)
    x[7, :4] = [127.0, 2.5, 3.5, -0.5]
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = tq.quantize_rows_reference(xt)
    jqv, jsv = _quant_rows(jnp.asarray(xt.float().numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsv)[:, 0])
    np.testing.assert_array_equal(q[7, :4].numpy(), [127, 2, 4, 0])
    assert (q[4] == 0).all() and s[4].item() == np.float32(1e-12) / \
        np.float32(127.0)


def test_quantize_encoder_params_matches_jax():
    """Same tree, bit-equal q and scale; q stored column-major (the CUDA
    int8 GEMM's layout); the JAX quantized tree bridged into torch equals
    the port's quantization of the bridged f32 tree."""
    from nbest_asr_tpu.models.encoder import EncoderConfig as JEnc
    from nbest_asr_tpu.models.encoder import init_encoder_params

    cfg = JEnc(vocab_size=53, hidden_size=128, num_layers=2, num_heads=2,
               intermediate_size=256, max_position=64)
    params = {"encoder": jax.device_get(init_encoder_params(
        jax.random.PRNGKey(0), cfg))}
    want = from_jax_numpy(jax.device_get(jq.quantize_encoder_params(params)))
    f32 = from_jax_numpy(params)
    got = tq.quantize_encoder_params(f32)
    assert jax.tree_util.tree_structure(
        jax.tree.map(lambda a: 0, got)) == jax.tree_util.tree_structure(
        jax.tree.map(lambda a: 0, want))
    lw, lg = want["encoder"]["layers"], got["encoder"]["layers"]
    for name in tq.LAYER_GEMM_KERNELS:
        assert tq.is_quantized(lg[name]) and tq.is_quantized(lw[name])
        q = lg[name]["q"]
        np.testing.assert_array_equal(q.numpy(), lw[name]["q"].numpy())
        np.testing.assert_array_equal(lg[name]["scale"].numpy(),
                                      lw[name]["scale"].numpy())
        assert q.transpose(-1, -2).is_contiguous()
        assert q[1].t().is_contiguous()     # what the GEMM wrapper checks
    # everything else is the caller's tensors, not copies
    assert lg["qkv_bias"] is f32["encoder"]["layers"]["qkv_bias"]
    assert got["encoder"]["embeddings"] is f32["encoder"]["embeddings"]
    assert not tq.is_quantized(f32["encoder"]["layers"]["qkv_kernel"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_int8_matches_jax(dtype):
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 24, 128) * 0.5).astype(np.float32)
    w = (rng.randn(128, 384) * 0.05).astype(np.float32)
    b = (rng.randn(384) * 0.1).astype(np.float32)
    jdt = getattr(jnp, dtype)
    wq, ws = jq.quantize_weight(jnp.asarray(w))
    want = np.asarray(jq.dense_int8(jnp.asarray(x).astype(jdt), wq, ws,
                                    jnp.asarray(b)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = tq.quantize_weight(torch.from_numpy(w))
    got = tq.dense_int8(xt, tq.kernel_layout(q), s, torch.from_numpy(b))
    assert got.dtype == xt.dtype and got.shape == (2, 24, 384)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                  2.0 ** -126))) - 7)
        assert (np.abs(got - want) <= ulp).all()


def test_int_dot_exact_at_the_extremes():
    """|acc| up to 127^2 * 3072 (> 2^24, where an f32 dot stops being
    exact) must come out exact."""
    rng = np.random.RandomState(6)
    xq = rng.randint(-127, 128, (5, 3072)).astype(np.int8)
    wq = rng.randint(-127, 128, (3072, 7)).astype(np.int8)
    xq[0], wq[:, 0] = 127, 127
    xq[1], wq[:, 1] = -127, 127
    want = xq.astype(np.int64) @ wq.astype(np.int64)
    got = tq.int_dot(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] == 127 * 127 * 3072 > 2 ** 24


def test_i8_wrappers_run_plain_on_cpu_and_refuse_device_mix():
    rng = np.random.RandomState(7)
    x = torch.from_numpy((rng.randn(24, 128) * 0.5).astype(np.float32))
    q, s = tq.quantize_weight(torch.from_numpy(
        (rng.randn(128, 256) * 0.05).astype(np.float32)))
    wq, ws = tq.kernel_layout(q), s.reshape(-1)
    bias = torch.zeros(256)
    resid = torch.zeros(24, 256, dtype=torch.bfloat16)
    _cuda.reset_launch_counts()
    xq, xs = K.quantize_rows(x)
    rq, rs = K.quantize_rows_reference(x)
    assert torch.equal(xq, rq) and torch.equal(xs, rs)
    y = K.gemm_i8_bias_act(xq, xs, wq, ws, bias, "gelu")
    assert y.dtype == torch.bfloat16 and torch.equal(
        y, K.gemm_i8_bias_act_reference(xq, xs, wq, ws, bias, "gelu"))
    r = K.gemm_i8_bias_residual(xq, xs, wq, ws, bias, resid)
    assert r.dtype == torch.float32 and torch.equal(
        r, K.gemm_i8_bias_residual_reference(xq, xs, wq, ws, bias, resid))
    assert all(v == 0 for v in _cuda.launch_counts.values())
    meta = torch.empty(24, 128, device="meta")
    with pytest.raises(ValueError, match="expected all on"):
        K.quantize_rows(meta)
    with pytest.raises(ValueError, match="expected all on"):
        K.gemm_i8_bias_act(xq, xs, wq.to("meta"), ws, bias)
    with pytest.raises(ValueError, match="expected all on"):
        K.gemm_i8_bias_residual(xq, xs, wq, ws, bias, resid.to("meta"))
    with pytest.raises(ValueError, match="act"):
        K.gemm_i8_bias_act(xq, xs, wq, ws, bias, "relu")
