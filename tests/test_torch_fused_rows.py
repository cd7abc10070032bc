"""The port's fused row kernels' Functions -- ``ops/fused_ln.py``,
``ops/fused_gelu.py``, ``ops/fused_embed.py`` -- and the encoder's
plain-block route through them (``use_fused_ln``, ``use_fused_gelu``,
``use_fused_embedding``) against the JAX package on the CPU, its Pallas
kernels in interpret mode, on inputs made by numpy from a seed.  On CPU
tensors the Functions run their kernels' plain versions.

Tolerances are those of ``tests/test_fused_kernels.py``: LayerNorm and
GELU forwards atol 1e-5; gradients atol 2e-4 / rtol 1e-4; the encoder
atol 2e-5 / rtol 1e-4 (f32 on both sides, differing in summation order).
The fused GELU's gradient is held to autograd through the port's plain
version, since JAX's own raises (ROADMAP.md, queue 3 item 1).  The train
step is held as ``tests/test_torch_train_step.py`` holds it.  The bf16
eval case holds the port to JAX's bf16 arithmetic on these routes: the
unfused path's bf16 residual sums put ~60% of its outputs off JAX's by a
bf16 ulp or more (mean |d| 3.0e-3), so at most 5% of outputs may differ
and mean |d| must stay <= 3e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nbest_asr_tpu.data.tokenizer import WordVocabTokenizer
from nbest_asr_tpu.models import encoder as jenc
from nbest_asr_tpu.models.model import ModelConfig as JModelConfig
from nbest_asr_tpu.models.model import init_model_params as j_init
from nbest_asr_tpu.ops.fused_embed import fused_embed_lookup as j_embed
from nbest_asr_tpu.ops.fused_gelu import fused_bias_gelu as j_gelu
from nbest_asr_tpu.ops.fused_ln import fused_residual_layer_norm as j_ln
from nbest_asr_tpu.serve import Predictor as JPredictor
from nbest_asr_tpu_torch.models import encoder as tenc
from nbest_asr_tpu_torch.models.model import ModelConfig
from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.ops import kernels as K
from nbest_asr_tpu_torch.ops.fused_embed import fused_embed_lookup
from nbest_asr_tpu_torch.ops.fused_gelu import fused_bias_gelu
from nbest_asr_tpu_torch.ops.fused_ln import fused_residual_layer_norm
from nbest_asr_tpu_torch.params_bridge import from_jax_numpy
from nbest_asr_tpu_torch.serve import Predictor

GRAD = dict(atol=2e-4, rtol=1e-4)
VOCAB = 67
ROWS = dict(use_fused_ln=True, use_fused_gelu=True, use_fused_embedding=True)


def _t(a):
    return torch.from_numpy(np.asarray(a)).requires_grad_(True)


@pytest.mark.parametrize("shape", [(2, 40, 256), (3, 16, 64)])
def test_fused_residual_layer_norm_matches_jax(shape):
    rng = np.random.RandomState(0)
    h = shape[-1]
    x, r, w = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    scale = (rng.rand(h) + 0.5).astype(np.float32)
    bias = rng.randn(h).astype(np.float32)

    def loss_j(*a):
        return jnp.sum(j_ln(*a) * w)

    with pltpu.force_tpu_interpret_mode():
        want = j_ln(x, r, scale, bias)
        jgrads = jax.grad(loss_j, argnums=(0, 1, 2, 3))(x, r, scale, bias)
    args = [_t(a) for a in (x, r, scale, bias)]
    got = fused_residual_layer_norm(*args)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    for a, jg, name in zip(args, jgrads, ("dx", "dr", "dscale", "dbias")):
        assert a.grad.shape == a.shape
        np.testing.assert_allclose(a.grad.numpy(), jg, err_msg=name, **GRAD)


def test_fused_bias_gelu_matches_jax_and_plain_autograd():
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 50, 128) * 2).astype(np.float32)
    b = rng.randn(128).astype(np.float32)
    w = rng.randn(3, 50, 128).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = j_gelu(x, b)
    xt, bt = _t(x), _t(b)
    got = fused_bias_gelu(xt, bt)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    xr, br = _t(x), _t(b)
    ref = K.bias_gelu_reference(xr.reshape(-1, 128), br).reshape(x.shape)
    (ref * torch.from_numpy(w)).sum().backward()
    assert bt.grad.shape == bt.shape
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), **GRAD)
    np.testing.assert_allclose(bt.grad.numpy(), br.grad.numpy(), **GRAD)
    # a (1, h) bias gets a (1, h) gradient
    b2 = _t(b.reshape(1, 128))
    fused_bias_gelu(torch.from_numpy(x), b2).sum().backward()
    assert b2.grad.shape == (1, 128)


@pytest.mark.parametrize("offset,types", [(0, True), (2, True), (0, False)],
                         ids=["offset0", "offset2", "no_type_ids"])
def test_fused_embed_lookup_matches_jax(offset, types):
    rng = np.random.RandomState(3)
    V, P, T, h, b, s = 50, 32, 2, 128, 3, 16
    word, pos, type_ = (rng.randn(n, h).astype(np.float32)
                        for n in (V, P, T))
    scale = (rng.rand(h) + 0.5).astype(np.float32)
    bias = rng.randn(h).astype(np.float32)
    ids = rng.randint(0, V, (b, s)).astype(np.int32)
    tids = rng.randint(0, T, (b, s)).astype(np.int32) if types else \
        np.zeros((b, s), np.int32)
    w = rng.randn(b, s, h).astype(np.float32)

    def loss_j(word, pos, type_, scale, bias):
        p = jax.lax.dynamic_slice_in_dim(pos, offset, s, axis=0)
        return jnp.sum(j_embed(word, p, type_, scale, bias, ids, tids, s)
                       * w)

    with pltpu.force_tpu_interpret_mode():
        want = j_embed(word, pos[offset:offset + s], type_, scale, bias,
                       ids, tids, s)
        jgrads = jax.grad(loss_j, argnums=tuple(range(5)))(
            word, pos, type_, scale, bias)
    tables = [_t(a) for a in (word, pos, type_, scale, bias)]
    got = fused_embed_lookup(
        tables[0], tables[1][offset:offset + s], *tables[2:],
        torch.from_numpy(ids), torch.from_numpy(tids) if types else None, s)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    for a, jg, name in zip(tables, jgrads,
                           ("dword", "dpos", "dtype", "dscale", "dbias")):
        np.testing.assert_allclose(a.grad.numpy(), jg, err_msg=name, **GRAD)


def test_fused_embed_lookup_refuses_rows_off_eight():
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_embed_lookup(torch.zeros(5, 128), torch.zeros(3, 128),
                           torch.zeros(2, 128), torch.ones(128),
                           torch.zeros(128), torch.zeros(1, 3, dtype=torch.int32),
                           None, 3)


def _encoders(dtype, **flags):
    kw = dict(hidden_size=128, num_layers=2, num_heads=2,
              intermediate_size=256, max_position=64, compute_dtype=dtype,
              **flags)
    jc = jenc.EncoderConfig(vocab_size=VOCAB, **kw)
    params = jax.device_get(jenc.init_encoder_params(jax.random.PRNGKey(0),
                                                     jc))
    rng = np.random.RandomState(1)
    ids = rng.randint(0, VOCAB, (4, 24)).astype(np.int32)
    mask = (rng.rand(4, 24) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    segs = (rng.rand(4, 24) > 0.5).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jenc.encoder_forward(params, jnp.asarray(ids),
                                    jnp.asarray(mask), jnp.asarray(segs), jc)
    _cuda.reset_launch_counts()
    with torch.no_grad():
        got = tenc.encoder_forward(
            from_jax_numpy(params), torch.from_numpy(ids),
            torch.from_numpy(mask), torch.from_numpy(segs),
            tenc.EncoderConfig(vocab_size=VOCAB, **kw))
    assert not any(_cuda.launch_counts.values())
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def test_encoder_with_fused_rows_matches_jax():
    got, want = _encoders("float32", **ROWS)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_bf16_eval_takes_jax_fused_arithmetic():
    got, want = _encoders("bfloat16", use_fused_ln=True, use_fused_gelu=True)
    d = np.abs(got - want)
    assert (d > 0).mean() <= 0.05, (d > 0).mean()
    assert d.mean() <= 3e-4, d.mean()


def test_predictor_with_fused_rows_matches_jax(tiny_memory):
    tok = WordVocabTokenizer(tiny_memory)
    kw = dict(vocab_size=tok.vocab_size, hidden_size=64, num_layers=2,
              num_heads=4, intermediate_size=128, max_position=320, **ROWS)
    jcfg = JModelConfig(encoder=jenc.EncoderConfig(**kw),
                        n_top=tiny_memory.n_top, n_bottom=tiny_memory.n_bottom)
    tcfg = ModelConfig(encoder=tenc.EncoderConfig(**kw),
                       n_top=tiny_memory.n_top, n_bottom=tiny_memory.n_bottom)
    params = jax.device_get(j_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    words = "i want chinese food in the north please thank you".split()
    utts = [" ".join(["[CLS]", "[SYS]", *rng.choice(words, 2), "[USR]",
                      " ".join(rng.choice(words, rng.randint(1, 20)))])
            for _ in range(11)]
    jp = JPredictor(params, jcfg, tiny_memory, tok, batch_size=8,
                    max_len=256, quantize="none")
    tp = Predictor(from_jax_numpy(params), tcfg, tiny_memory, tok,
                   device="cpu", batch_size=8, max_len=256)
    with pltpu.force_tpu_interpret_mode():
        j_labels, j_scores = jp.predict(utts), jp.scores(utts)
    assert tp.predict(utts) == j_labels
    np.testing.assert_allclose(tp.scores(utts), j_scores, atol=1e-4)


def test_train_step_with_fused_rows_matches_jax(tiny_memory):
    """Three steps at dropout 0, two micros each (step 0 trains at lr 0
    under warmup-linear), through both packages' ``make_train_step`` on
    the plain blocks: JAX with ``use_fused_ln`` and ``use_fused_embedding``
    in interpret mode, the port with ``use_fused_gelu`` as well (JAX
    cannot differentiate its fused GELU)."""
    from test_torch_train_step import (_compare, _host_data, _run_jax,
                                       _run_port, _step_indices)

    flags = dict(hidden_size=128, num_heads=2, intermediate_size=256,
                 num_layers=2, max_position=64, hidden_dropout=0.0,
                 attn_dropout=0.0, compute_dtype="float32",
                 use_fused_ln=True, use_fused_embedding=True)
    jcfg = JModelConfig(encoder=jenc.EncoderConfig(vocab_size=60, **flags),
                        n_top=tiny_memory.n_top, n_bottom=tiny_memory.n_bottom,
                        head_dropout=0.0)
    tcfg = ModelConfig(encoder=tenc.EncoderConfig(
        vocab_size=60, use_fused_gelu=True, **flags),
        n_top=tiny_memory.n_top, n_bottom=tiny_memory.n_bottom,
        head_dropout=0.0)
    params = jax.device_get(j_init(jax.random.PRNGKey(8), jcfg))
    data = _host_data(tiny_memory, 20, seed=5)
    idx = _step_indices(20)
    jparams, jstats = _run_jax(jcfg, tiny_memory, params, data, idx)
    tstate, tstats = _run_port(tcfg, tiny_memory, params, data, idx)
    _compare(params, jparams, jstats, tstate, tstats)
