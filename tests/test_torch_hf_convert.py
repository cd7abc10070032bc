"""The port's checkpoint reader and converter
(``nbest_asr_tpu_torch/models/hf_convert.py``) against the JAX package's
``nbest_asr_tpu/models/hf_convert.py`` and against ``transformers`` itself,
on the CPU, on tiny BERT, RoBERTa and XLM-R models built from a config in
this process (nothing is downloaded).

- ``convert_state_dict`` equals JAX's exactly, per family;
  ``config_from_hf`` on ``config.json`` equals JAX's on ``AutoConfig``,
  field by field; the port's encoder on the converted weights equals
  JAX's ``encoder_forward`` and the HF model's ``last_hidden_state`` at the
  non-pad positions (1e-4).
- ``load_pretrained_encoder`` reads ``pytorch_model.bin`` and
  ``model.safetensors`` (the port's own reader) as JAX's reads them
  through ``AutoModel``: old ``gamma`` / ``beta`` names, the ``bert.`` /
  ``roberta.`` prefixes, extra keys, fp16 and bf16 storage; any other
  layout raises, naming the files it looked for.
- A port export loads in ``BertModel.from_pretrained`` with no missing
  keys, and JAX's ``load_pretrained_encoder`` reads it as the port's does.
- The safetensors reader equals ``safetensors.torch.load_file`` for f32,
  f16 and bf16 tensors."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbest_asr_tpu.models import encoder as jenc
from nbest_asr_tpu.models import hf_convert as jhf
from nbest_asr_tpu_torch.models import encoder as tenc
from nbest_asr_tpu_torch.models import hf_convert as thf

ATOL = 1e-4
FAMILIES = ("bert", "roberta", "xlm-roberta")


def _hf_model(family, seed=0, **kw):
    from transformers import (BertConfig, BertModel, RobertaConfig,
                              RobertaModel, XLMRobertaConfig,
                              XLMRobertaModel)

    size = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64)
    size.update(kw)
    torch.manual_seed(seed)
    if family == "bert":
        cfg = BertConfig(max_position_embeddings=64, **size)
        model = BertModel(cfg, add_pooling_layer=False)
    else:
        cls_cfg, cls = ((RobertaConfig, RobertaModel) if family == "roberta"
                        else (XLMRobertaConfig, XLMRobertaModel))
        cfg = cls_cfg(max_position_embeddings=66, type_vocab_size=1,
                      pad_token_id=1, layer_norm_eps=1e-5, **size)
        model = cls(cfg, add_pooling_layer=False)
    # non-trivial LayerNorm and bias values
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "LayerNorm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn_like(p))
    return model.eval()


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    else:
        assert got.dtype == torch.float32, path
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=path)


def _jcfg(tcfg):
    return jenc.EncoderConfig(**dataclasses.asdict(tcfg))


@pytest.mark.parametrize("family", FAMILIES)
def test_convert_state_dict_equals_jax(family):
    model = _hf_model(family)
    tcfg = thf.config_from_hf(model.config.to_dict())
    sd = model.state_dict()
    got = thf.convert_state_dict(sd, tcfg)
    want = jhf.convert_state_dict(sd, _jcfg(tcfg))
    _assert_tree_equal(got, want)
    _assert_tree_equal(thf.convert_hf_model(model, tcfg), want)


@pytest.mark.parametrize("family", FAMILIES)
def test_config_from_hf_equals_jax(family, tmp_path):
    from transformers import AutoConfig

    _hf_model(family).save_pretrained(str(tmp_path))
    with open(tmp_path / "config.json") as fp:
        got = thf.config_from_hf(json.load(fp), hidden_dropout=0.0)
    want = jhf.config_from_hf(AutoConfig.from_pretrained(
        str(tmp_path), local_files_only=True), hidden_dropout=0.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.position_offset == (0 if family == "bert" else 2)


def test_config_from_hf_defaults_equal_jax():
    """Keys a config.json lacks take the defaults AutoConfig fills."""
    from transformers import AutoConfig

    for family in FAMILIES:
        d = {"model_type": family, "hidden_size": 64}
        want = jhf.config_from_hf(AutoConfig.for_model(**d))
        assert dataclasses.asdict(thf.config_from_hf(d)) == \
            dataclasses.asdict(want), family


def _inputs(vocab, pad_id, seed, b=3, s=24):
    rng = np.random.RandomState(seed)
    lens = [s, s - 7, 5]
    ids = np.full((b, s), pad_id, np.int32)
    mask = np.zeros((b, s), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(3, vocab, n)
        mask[i, :n] = 1
    return ids, mask


@pytest.mark.parametrize("family", FAMILIES)
def test_encoder_on_converted_weights_equals_jax_and_hf(family, tmp_path):
    model = _hf_model(family, seed=3)
    model.save_pretrained(str(tmp_path))
    tcfg, tparams = thf.load_pretrained_encoder(str(tmp_path),
                                                hidden_dropout=0.0,
                                                attn_dropout=0.0)
    jcfg, jparams = jhf.load_pretrained_encoder(str(tmp_path),
                                                hidden_dropout=0.0,
                                                attn_dropout=0.0)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _assert_tree_equal(tparams, jax.device_get(jparams))
    pad = 0 if family == "bert" else 1
    ids, mask = _inputs(tcfg.vocab_size, pad, seed=4)
    segs = np.zeros_like(ids)
    if family == "bert":
        segs[:, 10:] = 1
    got = tenc.encoder_forward(tparams, torch.from_numpy(ids),
                               torch.from_numpy(mask),
                               torch.from_numpy(segs), tcfg).numpy()
    want = np.asarray(jenc.encoder_forward(
        jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(segs),
        jcfg, deterministic=True))
    np.testing.assert_allclose(got, want, atol=ATOL)
    with torch.no_grad():
        hf = model(input_ids=torch.from_numpy(ids).long(),
                   attention_mask=torch.from_numpy(mask).long(),
                   token_type_ids=torch.from_numpy(segs).long()
                   ).last_hidden_state.numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], hf[real], atol=ATOL)


def _legacy_state_dict(sd, prefix):
    """``sd`` as an old or task checkpoint stores it: under ``prefix``,
    LayerNorm tensors named gamma / beta, with pooler, head and
    position-id extras."""
    out = {}
    for k, v in sd.items():
        k = prefix + k
        if k.endswith("LayerNorm.weight"):
            k = k[:-len("weight")] + "gamma"
        elif k.endswith("LayerNorm.bias"):
            k = k[:-len("bias")] + "beta"
        out[k] = v.clone()
    h = sd["embeddings.word_embeddings.weight"].shape[1]
    out[prefix + "pooler.dense.weight"] = torch.zeros(h, h)
    out["cls.predictions.bias"] = torch.zeros(3)
    out[prefix + "embeddings.position_ids"] = torch.arange(8)[None]
    return out


@pytest.mark.parametrize("layout", ["bin_gamma_beta", "safetensors_f16",
                                    "safetensors_bf16"])
def test_load_pretrained_encoder_reads_raw_state_dicts(layout, tmp_path):
    from safetensors.torch import save_file

    family = "bert" if layout == "bin_gamma_beta" else "roberta"
    model = _hf_model(family, seed=5)
    model.config.to_json_file(str(tmp_path / "config.json"))
    sd = model.state_dict()
    if layout == "bin_gamma_beta":
        torch.save(_legacy_state_dict(sd, "bert."),
                   tmp_path / "pytorch_model.bin")
    else:
        dt = torch.float16 if layout.endswith("f16") else torch.bfloat16
        sd = {k: v.to(dt) if v.is_floating_point() else v
              for k, v in sd.items()}
        save_file({"roberta." + k: v.contiguous() for k, v in sd.items()},
                  str(tmp_path / "model.safetensors"))
    tcfg, got = thf.load_pretrained_encoder(str(tmp_path))
    jcfg, want = jhf.load_pretrained_encoder(str(tmp_path))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _assert_tree_equal(got, jax.device_get(want))
    ref = thf.convert_state_dict({k: v.float() for k, v in sd.items()}, tcfg)
    _assert_tree_equal(got, {k: {n: t.numpy() for n, t in v.items()}
                             for k, v in ref.items()})


def test_load_pretrained_encoder_names_the_files_it_looked_for(tmp_path):
    with pytest.raises(OSError, match="config.json"):
        thf.load_pretrained_encoder(str(tmp_path / "absent"))
    _hf_model("bert").config.to_json_file(str(tmp_path / "config.json"))
    with pytest.raises(OSError, match="model.safetensors and "
                                      "pytorch_model.bin"):
        thf.load_pretrained_encoder(str(tmp_path))


def test_port_export_loads_in_bert_and_in_jax(tmp_path):
    from transformers import BertModel

    tcfg = tenc.EncoderConfig.tiny(vocab_size=90, hidden_size=32,
                                   max_position=48, layer_norm_eps=1e-7)
    params = tenc.init_encoder_params(torch.Generator().manual_seed(2), tcfg)
    thf.export_hf_checkpoint(tcfg, params, str(tmp_path), pooler_seed=3)
    model, info = BertModel.from_pretrained(
        str(tmp_path), local_files_only=True, output_loading_info=True)
    assert info["missing_keys"] == [] and info["mismatched_keys"] == []
    jcfg, jparams = jhf.load_pretrained_encoder(str(tmp_path))
    rcfg, rparams = thf.load_pretrained_encoder(str(tmp_path))
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(jcfg)
    assert (rcfg.vocab_size, rcfg.hidden_size, rcfg.layer_norm_eps) == (
        90, 32, 1e-7)
    _assert_tree_equal(rparams, jax.device_get(jparams))
    _assert_tree_equal(rparams, {k: {n: t.numpy() for n, t in v.items()}
                                 for k, v in params.items()})
    # the same files as JAX's export of the same params
    jdir = tmp_path / "jax"
    jhf.export_hf_checkpoint(_jcfg(tcfg), {k: {n: t.numpy() for n, t in
                                               v.items()}
                                           for k, v in params.items()},
                             str(jdir), pooler_seed=3)
    with open(tmp_path / "config.json") as a, open(jdir / "config.json") as b:
        got, want = json.load(a), json.load(b)
    want.pop("transformers_version")
    assert got == want
    a = torch.load(tmp_path / "pytorch_model.bin", weights_only=True)
    b = torch.load(jdir / "pytorch_model.bin", weights_only=True)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_safetensors_reader_equals_the_library(dtype, tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(7)
    tensors = {"a.weight": torch.randn(5, 7, generator=g).to(dtype),
               "b": torch.randn(3, generator=g).to(dtype),
               "c.scalar": torch.tensor(2.5).to(dtype),
               "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "empty": torch.zeros(0, 4, dtype=dtype)}
    save_file(tensors, str(tmp_path / "lib.safetensors"),
              metadata={"format": "pt"})
    got = thf.read_safetensors(str(tmp_path / "lib.safetensors"))
    want = load_file(str(tmp_path / "lib.safetensors"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


def test_export_round_trips_through_the_loader(tmp_path):
    """Export then ``load_pretrained_encoder``: every leaf exactly, from
    ``pytorch_model.bin`` and, with the same tensors saved as
    ``model.safetensors`` beside it, from that file first."""
    from safetensors.torch import save_file

    tcfg = tenc.EncoderConfig.tiny(vocab_size=64, hidden_size=32)
    params = tenc.init_encoder_params(torch.Generator().manual_seed(9), tcfg)
    want = {k: {n: t.numpy() for n, t in v.items()} for k, v in
            params.items()}
    thf.export_hf_checkpoint(tcfg, params, str(tmp_path))
    _, got = thf.load_pretrained_encoder(str(tmp_path))
    _assert_tree_equal(got, want)
    sd = torch.load(tmp_path / "pytorch_model.bin", weights_only=True)
    sd["bert.embeddings.word_embeddings.weight"] = \
        sd["bert.embeddings.word_embeddings.weight"] + 1.0
    save_file(sd, str(tmp_path / "model.safetensors"))
    _, got = thf.load_pretrained_encoder(str(tmp_path))
    want["embeddings"]["word"] = want["embeddings"]["word"] + 1.0
    _assert_tree_equal(got, want)
