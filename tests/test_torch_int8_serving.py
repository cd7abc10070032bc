"""The port's int8 serving slice against the JAX package on the same
seeded inputs and bridged weights: both int8 blocks (on the CPU their
plain versions) against the Pallas int8 megakernels in interpret mode,
the encoder's routing of quantized leaves, and ``Predictor(quantize=
"int8")`` against the JAX int8 Predictor.

Tolerances are the JAX int8 tests' own (``tests/test_int8_serving.py``):
2e-5 for the FFN block, 3e-5 for the attention block, 5e-5 through the
encoder; the Predictor is held as the bf16 Predictor is (identical label
lists, scores at atol 1e-4).  Both sides quantize bit for bit alike
(test_torch_quant.py), so what remains is f32 summation order and the
Pallas GELU's A&S erf."""

import dataclasses

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
from nbest_asr_tpu.ops import int8_serving as ji8
from nbest_asr_tpu.ops import quant as jq
from nbest_asr_tpu.serve import Predictor as JPredictor
from nbest_asr_tpu_torch.models import encoder as tenc
from nbest_asr_tpu_torch.models.model import ModelConfig
from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.ops import int8_serving as ti8
from nbest_asr_tpu_torch.ops import quant as tq
from nbest_asr_tpu_torch.params_bridge import from_jax_numpy
from nbest_asr_tpu_torch.serve import Predictor

H, INTER, HEADS = 128, 256, 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _quant(rng, shape):
    """JAX-quantized weight -> (jax q, jax scale, port q in the kernel
    layout, port scale)."""
    q, s = jq.quantize_weight(jnp.asarray(
        rng.randn(*shape).astype(np.float32) * 0.05))
    return q, s, tq.kernel_layout(_t(q)), _t(s)


def _vec(rng, n, std=0.1, one=False):
    return ((1.0 if one else 0.0) + std * rng.randn(n)).astype(np.float32)


def _counts_zero():
    return all(v == 0 for v in _cuda.launch_counts.values())


def test_int8_ffn_block_matches_pallas():
    rng = np.random.RandomState(0)
    x = (rng.randn(24, H) * 0.5).astype(np.float32)  # 24 rows: row padding
    w1 = _quant(rng, (H, INTER))
    w2 = _quant(rng, (INTER, H))
    b1, b2 = _vec(rng, INTER), _vec(rng, H)
    ls, lb = _vec(rng, H, one=True), _vec(rng, H)
    want = np.asarray(ji8.int8_ffn_block(
        jnp.asarray(x), w1[0], w1[1], b1, w2[0], w2[1], b2, ls, lb,
        interpret=True))
    args = (_t(x), w1[2], w1[3], _t(b1), w2[2], w2[3], _t(b2), _t(ls),
            _t(lb))
    _cuda.reset_launch_counts()
    got = ti8.int8_ffn_block(*args).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(
        got, ti8.int8_ffn_block_reference(*args).numpy())
    assert _counts_zero()


def _attn_mask(kind, b, s, rng):
    m = np.ones((b, s), np.float32)
    if kind == "padded":
        m[0, 17:] = 0.0
        m[2, 5:] = 0.0
        return m
    for i in range(b):                    # packed: segments 1, 2, 3, pads
        c = np.sort(rng.choice(np.arange(1, s), size=3, replace=False))
        m[i] = 0.0
        m[i, :c[0]], m[i, c[0]:c[1]], m[i, c[1]:c[2]] = 1, 2, 3
    return m


@pytest.mark.parametrize("kind", ["padded", "packed"])
def test_int8_attention_block_matches_pallas(kind):
    rng = np.random.RandomState(1)
    b, s = 3, 24                          # padding on both batch and seq
    x = (rng.randn(b, s, H) * 0.5).astype(np.float32)
    wqkv = _quant(rng, (H, 3 * H))
    wo = _quant(rng, (H, H))
    bqkv, bo = _vec(rng, 3 * H), _vec(rng, H)
    ls, lb = _vec(rng, H, one=True), _vec(rng, H)
    mask = _attn_mask(kind, b, s, rng)
    want = np.asarray(ji8.int8_attention_block(
        jnp.asarray(x), wqkv[0], wqkv[1], bqkv, wo[0], wo[1], bo, ls, lb,
        jnp.asarray(mask), n_heads=HEADS, interpret=True))
    args = (_t(x), wqkv[2], wqkv[3], _t(bqkv), wo[2], wo[3], _t(bo),
            _t(ls), _t(lb), _t(mask))
    _cuda.reset_launch_counts()
    got = ti8.int8_attention_block(*args, n_heads=HEADS).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)
    np.testing.assert_array_equal(got, ti8.int8_attention_block_reference(
        *args, n_heads=HEADS).numpy())
    assert _counts_zero()
    with pytest.raises(ValueError, match="seq"):
        ti8.int8_attention_block(torch.zeros(1, ti8.I8_MAX_SEQ + 1, H),
                                 *args[1:9], torch.ones(1, 513),
                                 n_heads=HEADS)


def _encoder_pair(hidden, heads, inter, fused):
    kw = dict(vocab_size=97, hidden_size=hidden, num_layers=2,
              num_heads=heads, intermediate_size=inter, max_position=64,
              use_fused_attn=fused, use_fused_ffn=fused)
    jcfg, tcfg = jenc.EncoderConfig(**kw), tenc.EncoderConfig(**kw)
    params = jenc.init_encoder_params(jax.random.PRNGKey(0), jcfg)
    jqp = jax.device_get(jq.quantize_encoder_params(
        {"encoder": params})["encoder"])
    tqp = tq.quantize_encoder_params(
        {"encoder": from_jax_numpy(jax.device_get(params))})["encoder"]
    return jcfg, tcfg, jqp, tqp


def _ids_mask(seed, b=2, s=24):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 97, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[1, 15:] = 0.0
    return ids, mask


def test_encoder_routes_quantized_leaves_to_int8_blocks(monkeypatch):
    """Quantized tree + use_fused_attn + use_fused_ffn (deterministic, no
    use_fused_attn_eval needed) takes both int8 blocks once per layer and
    gives the JAX encoder's numbers with its Pallas int8 kernels."""
    jcfg, tcfg, jqp, tqp = _encoder_pair(H, HEADS, INTER, fused=True)
    assert not tcfg.use_fused_attn_eval
    ids, mask = _ids_mask(2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jenc.encoder_forward(
            jqp, jnp.asarray(ids), jnp.asarray(mask), None, jcfg,
            deterministic=True))
    calls = {"ffn": 0, "attn": 0}
    real_ffn, real_attn = ti8.int8_ffn_block, ti8.int8_attention_block

    def spy_ffn(*a, **kw):
        calls["ffn"] += 1
        return real_ffn(*a, **kw)

    def spy_attn(*a, **kw):
        calls["attn"] += 1
        return real_attn(*a, **kw)

    monkeypatch.setattr(ti8, "int8_ffn_block", spy_ffn)
    monkeypatch.setattr(ti8, "int8_attention_block", spy_attn)
    got = tenc.encoder_forward(tqp, _t(ids), _t(mask), None, tcfg).numpy()
    assert calls == {"ffn": 2, "attn": 2}
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-5)
    # seq past I8_MAX_SEQ, or no fused flags: the plain int8 dense
    assert tenc.int8_attn_kernel_routes(tcfg, ti8.I8_MAX_SEQ)
    assert not tenc.int8_attn_kernel_routes(tcfg, ti8.I8_MAX_SEQ + 1)
    assert not tenc.int8_attn_kernel_routes(
        dataclasses.replace(tcfg, use_fused_attn=False), 64)


def test_encoder_qdense_path_matches_jax(monkeypatch):
    """Hidden 64 (no 128 lanes): quantized leaves take qdense through the
    plain int8 dense, as the JAX XLA dense_int8 path does."""
    jcfg, tcfg, jqp, tqp = _encoder_pair(64, 4, 128, fused=True)
    ids, mask = _ids_mask(3)
    want = np.asarray(jenc.encoder_forward(
        jqp, jnp.asarray(ids), jnp.asarray(mask), None, jcfg,
        deterministic=True))

    def refuse(*a, **kw):
        raise AssertionError("an int8 block was routed at hidden 64")

    monkeypatch.setattr(ti8, "int8_ffn_block", refuse)
    monkeypatch.setattr(ti8, "int8_attention_block", refuse)
    got = tenc.encoder_forward(tqp, _t(ids), _t(mask), None, tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-5)


# --------------------------------------------------------------------- #
# Predictor
# --------------------------------------------------------------------- #

WORDS = "i want chinese food in the north please thank you".split()


def _utterances(seed, n, max_words):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        sys_w = list(rng.choice(WORDS, size=rng.randint(1, 4)))
        hyps = [" ".join(rng.choice(WORDS, size=rng.randint(1, max_words)))
                for _ in range(rng.randint(1, 4))]
        out.append(" ".join(["[CLS]", "[SYS]", *sys_w, "[USR]",
                             " [SEP] ".join(hyps)]))
    return out


def _predictor_setup(memory, which):
    tok = WordVocabTokenizer(memory)
    kw = dict(vocab_size=tok.vocab_size, num_layers=2, max_position=320)
    if which == "tiny":
        kw.update(hidden_size=64, num_heads=4, intermediate_size=128)
    else:
        kw.update(hidden_size=H, num_heads=HEADS, intermediate_size=INTER,
                  use_fused_attn=True, use_fused_ffn=True)
    jcfg = JModelConfig(encoder=jenc.EncoderConfig(**kw), n_top=memory.n_top,
                        n_bottom=memory.n_bottom)
    tcfg = ModelConfig(encoder=tenc.EncoderConfig(**kw), n_top=memory.n_top,
                       n_bottom=memory.n_bottom)
    params = jax.device_get(j_init(jax.random.PRNGKey(0), jcfg))
    return tok, jcfg, tcfg, params


def _jax_int8(params, jcfg, memory, tok, utts):
    with pltpu.force_tpu_interpret_mode():
        jp = JPredictor(params, jcfg, memory, tok, batch_size=8,
                        max_len=256, quantize="int8")
        assert jp.quantize == "int8"
        return jp.predict(utts), jp.scores(utts)


@pytest.mark.parametrize("which", ["tiny", "routable"])
def test_int8_predictor_matches_jax(tiny_memory, which, monkeypatch):
    memory = tiny_memory
    tok, jcfg, tcfg, params = _predictor_setup(memory, which)
    utts = _utterances(0, 13, 8) + _utterances(1, 4, 30)    # two buckets
    j_labels, j_scores = _jax_int8(params, jcfg, memory, tok, utts)
    calls = {"n": 0}
    real = ti8.int8_ffn_block

    def spy(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ti8, "int8_ffn_block", spy)
    tp = Predictor(from_jax_numpy(params), tcfg, memory, tok, device="cpu",
                   batch_size=8, max_len=256, quantize="int8")
    assert tp.quantize == "int8"
    _cuda.reset_launch_counts()
    assert tp.predict(utts) == j_labels
    np.testing.assert_allclose(tp.scores(utts), j_scores, atol=1e-4)
    assert tp.predict_async(utts[:5]).result() == j_labels[:5]
    assert _counts_zero()
    # the routable config runs the int8 blocks, the tiny one never does
    assert (calls["n"] > 0) == (which == "routable")
    # batching invariance
    p3 = Predictor(from_jax_numpy(params), tcfg, memory, tok,
                   batch_size=3, quantize="int8", device="cpu")
    np.testing.assert_allclose(p3.scores(utts), tp.scores(utts), atol=1e-5)
    assert p3.predict(utts) == tp.predict(utts)


def test_int8_parity_is_red_capable(tiny_memory):
    """One layer's corrupted scales in the port's quantized tree must
    break the parity above: the test watches the quantized math."""
    memory = tiny_memory
    tok, jcfg, tcfg, params = _predictor_setup(memory, "routable")
    utts = _utterances(0, 13, 8)
    _, j_scores = _jax_int8(params, jcfg, memory, tok, utts)
    tp = Predictor(from_jax_numpy(params), tcfg, memory, tok, batch_size=8,
                   quantize="int8", device="cpu")
    np.testing.assert_allclose(tp.scores(utts), j_scores, atol=1e-4)
    tp._fwd_params["encoder"]["layers"]["ffn_out_kernel"]["scale"][0] *= 7.3
    assert np.abs(tp.scores(utts) - j_scores).max() > 1e-2


def test_predictor_takes_a_quantized_tree(tiny_memory):
    """A tree that arrives quantized (the JAX package's, bridged: int8
    leaves row-major) serves exactly as the port's own quantization of
    the f32 tree, under quantize="int8" and under "none" (the leaves
    decide, as in the JAX encoder)."""
    memory = tiny_memory
    tok, jcfg, tcfg, params = _predictor_setup(memory, "routable")
    utts = _utterances(5, 9, 8)
    own = Predictor(from_jax_numpy(params), tcfg, memory, tok, batch_size=8,
                    quantize="int8", device="cpu").scores(utts)
    bridged = from_jax_numpy(jax.device_get(
        jq.quantize_encoder_params(params)))
    for mode in ("int8", "none"):
        tp = Predictor(bridged, tcfg, memory, tok, batch_size=8,
                       quantize=mode, device="cpu")
        q = tp._fwd_params["encoder"]["layers"]["ffn_in_kernel"]["q"]
        assert q.transpose(-1, -2).is_contiguous()    # the kernels' layout
        np.testing.assert_array_equal(tp.scores(utts), own)
