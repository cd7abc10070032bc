"""The port's Predictor on the CPU against the JAX Predictor in bf16
serving mode (``quantize="none"``) on the same weights: identical label
lists, scores at atol 1e-4 (f32 on both sides; see test_torch_model.py),
invariance to batching, the same bucket choice, the refusals, and the
serving-mode defaults.  The int8 mode's parity with JAX is in
test_torch_int8_serving.py."""

import jax
import numpy as np
import pytest
import torch

from nbest_asr_tpu.data.tokenizer import WordVocabTokenizer
from nbest_asr_tpu.models.encoder import EncoderConfig as JEncoderConfig
from nbest_asr_tpu.models.model import ModelConfig as JModelConfig
from nbest_asr_tpu.models.model import init_model_params as j_init
from nbest_asr_tpu.serve import Predictor as JPredictor
from nbest_asr_tpu_torch.models.encoder import EncoderConfig
from nbest_asr_tpu_torch.models.model import ModelConfig
from nbest_asr_tpu_torch.params_bridge import from_jax_numpy
from nbest_asr_tpu_torch.serve import Predictor

ATOL = 1e-4
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


@pytest.fixture(scope="module")
def setup(tiny_memory):
    tok = WordVocabTokenizer(tiny_memory)
    kw = dict(vocab_size=tok.vocab_size, hidden_size=64, num_layers=2,
              num_heads=4, intermediate_size=128, max_position=320)
    jcfg = JModelConfig(encoder=JEncoderConfig(**kw),
                        n_top=tiny_memory.n_top,
                        n_bottom=tiny_memory.n_bottom)
    tcfg = ModelConfig(encoder=EncoderConfig(**kw), n_top=tiny_memory.n_top,
                       n_bottom=tiny_memory.n_bottom)
    params = jax.device_get(j_init(jax.random.PRNGKey(0), jcfg))
    return tiny_memory, tok, jcfg, tcfg, params


def test_predictor_matches_jax(setup):
    memory, tok, jcfg, tcfg, params = setup
    utts = _utterances(0, 21, 8) + _utterances(1, 6, 30)   # two buckets
    jp = JPredictor(params, jcfg, memory, tok, batch_size=8, max_len=256,
                    quantize="none")
    tp = Predictor(from_jax_numpy(params), tcfg, memory, tok, device="cpu",
                   batch_size=8, max_len=256)
    assert tp.quantize == "none"
    assert tp.predict(utts) == jp.predict(utts)
    np.testing.assert_allclose(tp.scores(utts), jp.scores(utts), atol=ATOL)
    handle = tp.predict_async(utts[:5])
    assert handle.result() == jp.predict(utts[:5])
    assert handle.result() == handle.result()


def test_batching_invariance(setup):
    memory, tok, _, tcfg, params = setup
    utts = _utterances(2, 11, 10)
    p4 = Predictor(from_jax_numpy(params), tcfg, memory, tok, batch_size=4,
                   device="cpu")
    p16 = Predictor(from_jax_numpy(params), tcfg, memory, tok,
                    batch_size=16, device="cpu")
    np.testing.assert_allclose(p4.scores(utts), p16.scores(utts),
                               atol=1e-5)
    assert p4.predict(utts) == p16.predict(utts)
    assert p4.predict(utts)[:3] == p4.predict(utts[:3])


@pytest.mark.parametrize("max_words", [3, 12, 40])
def test_bucket_choice_matches_jax(setup, max_words):
    memory, tok, jcfg, tcfg, params = setup
    seqs = [u.split() for u in _utterances(3 + max_words, 9, max_words)]
    jp = JPredictor(params, jcfg, memory, tok, batch_size=8, max_len=256,
                    quantize="none")
    tp = Predictor(from_jax_numpy(params), tcfg, memory, tok, batch_size=8,
                   max_len=256, device="cpu")
    got, want = tp._pack(seqs), jp._pack(seqs)
    assert got.max_len == want.max_len and got.max_len in tp.bucket_lens
    np.testing.assert_array_equal(got.input_ids, want.input_ids)
    np.testing.assert_array_equal(got.attn_mask, want.attn_mask)
    np.testing.assert_array_equal(got.segment_ids, want.segment_ids)


def test_refusals(setup, monkeypatch):
    memory, tok, _, tcfg, params = setup
    tparams = from_jax_numpy(params)
    with pytest.raises(ValueError, match="quantize"):
        Predictor(tparams, tcfg, memory, tok, quantize="fp8", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(tparams, tcfg, memory, tok, device="cuda")


def test_default_device_is_the_card(setup, monkeypatch):
    """Predictor(...) without a device runs on the card: it raises where
    there is no CUDA instead of serving on the CPU."""
    memory, tok, _, tcfg, params = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(from_jax_numpy(params), tcfg, memory, tok)


def test_int8_accepted_on_cpu(setup):
    """quantize="int8" builds the quantized tree once and serves through
    the plain int8 dense on the CPU."""
    memory, tok, _, tcfg, params = setup
    tp = Predictor(from_jax_numpy(params), tcfg, memory, tok,
                   quantize="int8", batch_size=4, device="cpu")
    assert tp.quantize == "int8"
    layers = tp._fwd_params["encoder"]["layers"]
    assert layers["qkv_kernel"]["q"].dtype == torch.int8
    assert tp.params["encoder"]["layers"]["qkv_kernel"].dtype == torch.float32
    utts = _utterances(4, 5, 6)
    sc = tp.scores(utts)
    assert sc.shape == (5, memory.n_bottom) and np.isfinite(sc).all()
    assert len(tp.predict(utts)) == 5


def test_fused_attn_eval_default_scoped_to_cuda(setup):
    """Auto-on only where the kernels run (CUDA); explicit wins; the
    caller's config is never mutated.  quantize=None resolves to "none"
    on the CPU even where the int8 kernels would take every layer."""
    import dataclasses

    from nbest_asr_tpu_torch import serve

    memory, tok, _, tcfg, params = setup
    kcfg = dataclasses.replace(tcfg, encoder=dataclasses.replace(
        tcfg.encoder, use_fused_attn=True))
    tparams = from_jax_numpy(params)
    auto = Predictor(tparams, kcfg, memory, tok, device="cpu")
    assert not auto.cfg.encoder.use_fused_attn_eval
    assert auto.quantize == "none"
    on = Predictor(tparams, kcfg, memory, tok, fused_attn_eval=True,
                   device="cpu")
    assert on.cfg.encoder.use_fused_attn_eval
    assert not kcfg.encoder.use_fused_attn_eval
    lanes = dataclasses.replace(tcfg, encoder=dataclasses.replace(
        tcfg.encoder, hidden_size=128, num_heads=2, intermediate_size=256,
        use_fused_attn=True, use_fused_ffn=True))
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert serve.resolve_quantize(None, lanes, cpu) == "none"
    assert serve.resolve_quantize("int8", lanes, cpu) == "int8"
    assert serve.resolve_quantize("none", lanes, cuda) == "none"
    assert serve.resolve_quantize(None, tcfg, cuda) == "none"   # no lanes
    assert serve.resolve_quantize(None, lanes, cuda) == (
        "int8" if serve.INT8_FASTER_ON_CUDA else "none")
