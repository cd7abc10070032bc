"""HuggingFace BERT / RoBERTa / XLM-R checkpoints <-> the port's encoder
params -- the port of ``nbest_asr_tpu/models/hf_convert.py``
(``convert_state_dict`` :33, ``convert_hf_model`` :93, ``config_from_hf``
:104, ``export_hf_checkpoint`` :125, ``load_pretrained_encoder`` :214).

The port shares JAX's parameter layout, so the conversion is the same:
torch ``nn.Linear`` weights are (out, in) and the encoder's GEMM kernels
(in, out), so they are transposed; q, k and v are concatenated into one
(h, 3h) kernel; per-layer tensors are stacked on a leading
``num_layers`` axis.  Every tensor is cast to f32, as JAX's ``_np`` casts.

JAX reads a checkpoint through ``transformers`` (``AutoConfig``,
``AutoModel``).  The port reads the directory itself, so that it needs
neither ``transformers`` nor ``safetensors``:

- ``config.json`` with ``json``; keys it lacks take the defaults of
  ``BertConfig``, ``RobertaConfig`` or ``XLMRobertaConfig``;
- ``model.safetensors`` with ``read_safetensors`` (an 8-byte
  little-endian header length, a JSON header of dtype, shape and data
  offsets per tensor, then the raw bytes), else ``pytorch_model.bin``
  with ``torch.load(weights_only=True)``;
- the state dict as ``AutoModel`` would hand it over: LayerNorm tensors
  named ``gamma`` / ``beta`` (old BERT checkpoints) renamed to
  ``weight`` / ``bias``, the encoder found under no prefix or ``bert.``,
  ``roberta.`` or ``model.``, and extra keys (``pooler.*``, ``cls.*``,
  ``lm_head.*``, position-id buffers) ignored.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from .encoder import EncoderConfig

ENCODER_PREFIXES = ("", "bert.", "roberta.", "model.")
WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")

# the defaults of BertConfig, RobertaConfig and XLMRobertaConfig for the
# keys config_from_hf reads: shared but for RobertaConfig's vocab_size
HF_VOCAB_DEFAULTS = {"roberta": 50265}
HF_DEFAULTS = dict(model_type="bert", vocab_size=30522, hidden_size=768,
                   num_hidden_layers=12, num_attention_heads=12,
                   intermediate_size=3072, max_position_embeddings=512,
                   type_vocab_size=2, layer_norm_eps=1e-12,
                   hidden_dropout_prob=0.1,
                   attention_probs_dropout_prob=0.1)

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


# --------------------------------------------------------------------- #
# safetensors without the package
# --------------------------------------------------------------------- #

def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor}, as
    ``safetensors.torch.load_file`` returns it."""
    with open(path, "rb") as fp:
        n = int.from_bytes(fp.read(8), "little")
        header = json.loads(fp.read(n))
        data = bytearray(fp.read())
    buf = torch.frombuffer(data, dtype=torch.uint8) if data else \
        torch.empty(0, dtype=torch.uint8)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{meta['dtype']}, which the reader does not "
                             f"take ({sorted(_ST_DTYPES)})")
        begin, end = meta["data_offsets"]
        # clone: a fresh, aligned storage for the dtype view
        raw = buf[begin:end].clone()
        out[name] = raw.view(_ST_DTYPES[meta["dtype"]]).reshape(
            meta["shape"])
    return out


# --------------------------------------------------------------------- #
# state dict <-> params
# --------------------------------------------------------------------- #

def _f32(t) -> torch.Tensor:
    # a copy, as JAX's _np copies: later edits of the source state dict
    # must not reach the params
    return t.detach().to("cpu", torch.float32).clone()


def convert_state_dict(sd: Dict, cfg: EncoderConfig,
                       prefix: str = "") -> dict:
    """transformers BERT / RoBERTa / XLM-R state dict -> the encoder's
    param tree (f32, on the CPU).  ``prefix`` strips a leading module path
    (``"bert."``, ``"roberta."``)."""
    def g(name):
        key = prefix + name
        if key not in sd:
            raise KeyError(f"missing tensor in checkpoint: {key}")
        return _f32(sd[key])

    emb = {
        "word": g("embeddings.word_embeddings.weight"),
        "position": g("embeddings.position_embeddings.weight"),
        "ln_scale": g("embeddings.LayerNorm.weight"),
        "ln_bias": g("embeddings.LayerNorm.bias"),
    }
    tt_key = prefix + "embeddings.token_type_embeddings.weight"
    if tt_key in sd:
        emb["type"] = _f32(sd[tt_key])
    else:
        emb["type"] = torch.zeros(max(cfg.type_vocab_size, 1),
                                  cfg.hidden_size)
    stacks: Dict[str, list] = {k: [] for k in (
        "qkv_kernel", "qkv_bias", "attn_out_kernel", "attn_out_bias",
        "attn_ln_scale", "attn_ln_bias", "ffn_in_kernel", "ffn_in_bias",
        "ffn_out_kernel", "ffn_out_bias", "ffn_ln_scale", "ffn_ln_bias")}
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        att = p + "attention.self."
        stacks["qkv_kernel"].append(torch.cat(
            [g(att + f"{n}.weight").t() for n in ("query", "key", "value")],
            dim=1))
        stacks["qkv_bias"].append(torch.cat(
            [g(att + f"{n}.bias") for n in ("query", "key", "value")]))
        stacks["attn_out_kernel"].append(
            g(p + "attention.output.dense.weight").t())
        stacks["attn_out_bias"].append(g(p + "attention.output.dense.bias"))
        stacks["attn_ln_scale"].append(
            g(p + "attention.output.LayerNorm.weight"))
        stacks["attn_ln_bias"].append(
            g(p + "attention.output.LayerNorm.bias"))
        stacks["ffn_in_kernel"].append(g(p + "intermediate.dense.weight").t())
        stacks["ffn_in_bias"].append(g(p + "intermediate.dense.bias"))
        stacks["ffn_out_kernel"].append(g(p + "output.dense.weight").t())
        stacks["ffn_out_bias"].append(g(p + "output.dense.bias"))
        stacks["ffn_ln_scale"].append(g(p + "output.LayerNorm.weight"))
        stacks["ffn_ln_bias"].append(g(p + "output.LayerNorm.bias"))
    layers = {k: torch.stack(v).contiguous() for k, v in stacks.items()}
    return {"embeddings": emb, "layers": layers}


def _encoder_prefix(sd: Dict) -> str:
    for prefix in ENCODER_PREFIXES:
        if prefix + "embeddings.word_embeddings.weight" in sd:
            return prefix
    raise KeyError("could not locate a BERT-family encoder in checkpoint")


def convert_hf_model(model_or_state_dict, cfg: EncoderConfig) -> dict:
    """A live transformers model (``BertModel``, ``RobertaModel``,
    ``XLMRobertaModel`` or a task model wrapping one) or its state dict
    -> encoder params; the encoder is found under no prefix or one of
    ``ENCODER_PREFIXES``."""
    sd = model_or_state_dict
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_state_dict(sd, cfg, _encoder_prefix(sd))


def _get(hf_config, key: str):
    default = HF_DEFAULTS[key]
    if key == "vocab_size":
        default = HF_VOCAB_DEFAULTS.get(_get(hf_config, "model_type"),
                                        default)
    if isinstance(hf_config, dict):
        return hf_config.get(key, default)
    return getattr(hf_config, key, default)


def config_from_hf(hf_config, **overrides) -> EncoderConfig:
    """A transformers config, or the dict of its ``config.json`` ->
    ``EncoderConfig`` (bert / roberta / xlm-roberta: position offset 2 for
    the last two)."""
    is_roberta = _get(hf_config, "model_type") in ("roberta", "xlm-roberta")
    kw = dict(
        vocab_size=_get(hf_config, "vocab_size"),
        hidden_size=_get(hf_config, "hidden_size"),
        num_layers=_get(hf_config, "num_hidden_layers"),
        num_heads=_get(hf_config, "num_attention_heads"),
        intermediate_size=_get(hf_config, "intermediate_size"),
        max_position=_get(hf_config, "max_position_embeddings"),
        type_vocab_size=_get(hf_config, "type_vocab_size"),
        layer_norm_eps=_get(hf_config, "layer_norm_eps"),
        position_offset=2 if is_roberta else 0,
        hidden_dropout=_get(hf_config, "hidden_dropout_prob"),
        attn_dropout=_get(hf_config, "attention_probs_dropout_prob"),
    )
    kw.update(overrides)
    return EncoderConfig(**kw)


def export_hf_checkpoint(cfg: EncoderConfig, enc_params: dict, out_dir: str,
                         extra_state: Optional[Dict] = None,
                         pooler_seed: int = 0) -> None:
    """Encoder params -> a local HuggingFace BERT checkpoint directory, the
    exact inverse of ``convert_state_dict``: ``config.json`` with the keys
    ``BertConfig(...).to_json_file`` writes (but ``transformers_version``)
    and ``pytorch_model.bin`` that ``load_pretrained_encoder`` -- the
    port's or JAX's -- and ``BertModel.from_pretrained`` read back.
    Weights go under ``bert.`` (BertForMaskedLM's layout), f32 on the CPU;
    ``extra_state`` adds tensors such as the MLM head's
    ``cls.predictions.*`` (``train/mlm.mlm_head_export_state``); a pooler
    drawn from ``torch.Generator().manual_seed(pooler_seed)`` (normal, std
    ``initializer_range``, zero bias), as JAX's, lets ``BertModel`` load
    without missing keys."""
    emb = enc_params["embeddings"]
    lay = enc_params["layers"]
    h = cfg.hidden_size
    sd = {
        "embeddings.word_embeddings.weight": emb["word"],
        "embeddings.position_embeddings.weight": emb["position"],
        "embeddings.token_type_embeddings.weight": emb["type"],
        "embeddings.LayerNorm.weight": emb["ln_scale"],
        "embeddings.LayerNorm.bias": emb["ln_bias"],
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        qkv_k, qkv_b = lay["qkv_kernel"][i], lay["qkv_bias"][i]
        for j, name in enumerate(("query", "key", "value")):
            sd[p + f"attention.self.{name}.weight"] = \
                qkv_k[:, j * h:(j + 1) * h].t()
            sd[p + f"attention.self.{name}.bias"] = qkv_b[j * h:(j + 1) * h]
        sd[p + "attention.output.dense.weight"] = lay["attn_out_kernel"][i].t()
        sd[p + "attention.output.dense.bias"] = lay["attn_out_bias"][i]
        sd[p + "attention.output.LayerNorm.weight"] = lay["attn_ln_scale"][i]
        sd[p + "attention.output.LayerNorm.bias"] = lay["attn_ln_bias"][i]
        sd[p + "intermediate.dense.weight"] = lay["ffn_in_kernel"][i].t()
        sd[p + "intermediate.dense.bias"] = lay["ffn_in_bias"][i]
        sd[p + "output.dense.weight"] = lay["ffn_out_kernel"][i].t()
        sd[p + "output.dense.bias"] = lay["ffn_out_bias"][i]
        sd[p + "output.LayerNorm.weight"] = lay["ffn_ln_scale"][i]
        sd[p + "output.LayerNorm.bias"] = lay["ffn_ln_bias"][i]
    sd = {"bert." + k: _f32(v).contiguous() for k, v in sd.items()}
    g = torch.Generator().manual_seed(pooler_seed)
    sd["bert.pooler.dense.weight"] = torch.empty(h, h).normal_(
        0.0, cfg.initializer_range, generator=g)
    sd["bert.pooler.dense.bias"] = torch.zeros(h)
    if extra_state:
        sd.update({k: _f32(torch.as_tensor(v)).contiguous()
                   for k, v in extra_state.items()})
    config = dict(
        architectures=["BertForMaskedLM"],
        attention_probs_dropout_prob=cfg.attn_dropout,
        classifier_dropout=None,
        hidden_act="gelu",
        hidden_dropout_prob=cfg.hidden_dropout,
        hidden_size=cfg.hidden_size,
        initializer_range=0.02,
        intermediate_size=cfg.intermediate_size,
        layer_norm_eps=cfg.layer_norm_eps,
        max_position_embeddings=cfg.max_position,
        model_type="bert",
        num_attention_heads=cfg.num_heads,
        num_hidden_layers=cfg.num_layers,
        pad_token_id=0,
        position_embedding_type="absolute",
        type_vocab_size=cfg.type_vocab_size,
        use_cache=True,
        vocab_size=cfg.vocab_size,
    )
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as fp:
        json.dump(config, fp, indent=2, sort_keys=True)
        fp.write("\n")
    torch.save(sd, os.path.join(out_dir, "pytorch_model.bin"))


# --------------------------------------------------------------------- #
# reading a checkpoint directory
# --------------------------------------------------------------------- #

def load_pretrained_encoder(path: str, **overrides):
    """A local checkpoint directory -> (EncoderConfig, encoder params on
    the CPU, f32): ``config.json``, then ``model.safetensors`` if present,
    else ``pytorch_model.bin``.  ``overrides`` replace config fields
    (dropout, compute dtype, the kernel flags).  A path that is not a
    directory holding ``config.json`` and the weights raises ``OSError``
    naming the files it looked for."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.isfile(cfg_path):
        raise OSError(f"no checkpoint directory at {path!r}: looked for "
                      f"config.json and {' or '.join(WEIGHT_FILES)}")
    with open(cfg_path) as fp:
        cfg = config_from_hf(json.load(fp), **overrides)
    files = [os.path.join(path, f) for f in WEIGHT_FILES]
    if os.path.isfile(files[0]):
        raw = read_safetensors(files[0])
    elif os.path.isfile(files[1]):
        raw = torch.load(files[1], map_location="cpu", weights_only=True)
    else:
        raise OSError(f"no weights in {path!r}: looked for "
                      f"{' and '.join(WEIGHT_FILES)}")
    # the names AutoModel hands over: old checkpoints' LayerNorm gamma /
    # beta are weight / bias
    sd = {}
    for k, v in raw.items():
        if k.endswith("LayerNorm.gamma"):
            k = k[:-len("gamma")] + "weight"
        elif k.endswith("LayerNorm.beta"):
            k = k[:-len("beta")] + "bias"
        sd[k] = v
    return cfg, convert_state_dict(sd, cfg, _encoder_prefix(sd))
