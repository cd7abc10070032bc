"""BERT-family transformer encoder in PyTorch -- the port of
``nbest_asr_tpu/models/encoder.py``.

Parameters keep the JAX layout so that ``params_bridge`` is a dict walk:
GEMM kernels are (in, out), and every per-layer leaf is stacked on a
leading ``num_layers`` axis.  The layer loop is a Python loop over that
axis.  Params are f32 masters; the forward casts the four GEMM kernels to
the compute dtype, which is free when the caller (the Predictor) already
holds compute copies.  A GEMM kernel may instead be an int8-quantized
``{"q", "scale"}`` leaf (``ops/quant.py:quantize_encoder_params``).

Routing per layer, as the JAX encoder routes (``encoder.py:322-443``,
without the TPU's VMEM budget), with "lanes" meaning JAX's rule, hidden
a multiple of 128 and a head dim a multiple of 64 (``attn_lanes_ok``),
and "the kernels take the head dim" meaning 64 or 128
(``attn_kernels_take``):

- a quantized QKV kernel sends the attention block to
  ``ops.int8_serving.int8_attention_block`` when ``use_fused_attn`` is
  set, the lanes hold, the kernels take the head dim and seq <= 512
  (``use_fused_attn_eval`` is not needed, as in JAX); a tensor one to
  ``ops.fused_attention`` when ``use_fused_attn`` and
  ``use_fused_attn_eval`` are set, the lanes hold, the kernels take the
  head dim and seq <= 512;
- the FFN block goes to ``ops.int8_serving.int8_ffn_block`` (quantized
  leaves) or ``ops.fused_ffn`` (tensor leaves) when ``use_fused_ffn`` is
  set and hidden and intermediate are multiples of 128;
- otherwise the plain path runs, exactly as the JAX XLA path does, with
  ``qdense`` taking either kind of leaf.

Training (``deterministic=False``) needs an explicit ``seed``; every
dropout site takes its own seed from it with ``philox.fold_in`` (per
layer, then per site: 1 attention probs, 2 attention hidden, 3 FFN, and
0xE the embeddings -- the JAX ``fold_in`` structure, ``encoder.py:201,
315, 366-441``).  The attention block routes to ``ops.fused_attention``
(the kernel chains, Philox streams 3 and 4 under the one site-1 seed, as
JAX's ``fold_in(lrng, 1)`` covers the whole block) where JAX routes it
to its megakernel: ``use_fused_attn``, the lanes and seq <= 512
(``attn_train_routes``); otherwise it runs the plain path with
probability and hidden dropout.  The FFN block routes to
``ops.fused_ffn`` (the kernel chains, Philox masks) when
``use_fused_ffn`` and the lanes hold, and otherwise runs the plain FFN
with ``layers.dropout``.  Where JAX would train through a kernel the
port does not have -- the attention megakernel at a head dim its kernels
do not take, flash attention, the int8 training GEMMs, the fused LN /
GELU / embedding kernels -- the forward raises ``NotImplementedError``
rather than run the plain path quietly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.attention import multi_head_attention
from ..ops.kernels import HEAD_DIMS
from ..ops.layers import dense, dropout, gelu, layer_norm
from ..ops.philox import fold_in, generator
from ..ops.quant import dense_int8, is_quantized

GEMM_KERNELS = ("qkv_kernel", "attn_out_kernel", "ffn_in_kernel",
                "ffn_out_kernel")


@dataclass(frozen=True)
class EncoderConfig:
    """Same fields and defaults as the JAX ``EncoderConfig``.  The port
    reads the sizes, dropout rates, ``compute_dtype`` and the three
    routing flags ``use_fused_attn``, ``use_fused_attn_eval`` and
    ``use_fused_ffn``; in training the flags of kernels it has not ported
    raise (module docstring); ``remat`` and ``scan_unroll`` steer the
    TPU's scan and are kept so one configuration describes both
    packages."""

    vocab_size: int
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    position_offset: int = 0
    initializer_range: float = 0.02
    compute_dtype: str = "float32"
    use_flash_attention: bool = False
    flash_min_seq: int = 160
    use_fused_ln: bool = False
    use_fused_gelu: bool = False
    use_fused_embedding: bool = False
    use_fused_ffn: bool = False
    use_fused_attn: bool = False
    use_int8_train: bool = False
    use_int8_train_bwd: bool = False
    use_int8_train_attn: bool = False
    use_fused_attn_eval: bool = False
    remat: bool = False
    scan_unroll: int = 1

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden {self.hidden_size} is not a multiple "
                             f"of num_heads {self.num_heads}")
        return self.hidden_size // self.num_heads

    @property
    def cdtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float64": torch.float64}[self.compute_dtype]

    @staticmethod
    def bert_base(vocab_size: int = 30522, **kw) -> "EncoderConfig":
        return EncoderConfig(vocab_size=vocab_size, **kw)

    @staticmethod
    def xlmr_base(**kw) -> "EncoderConfig":
        kw.setdefault("type_vocab_size", 1)
        return EncoderConfig(vocab_size=250002, max_position=514,
                             position_offset=2, layer_norm_eps=1e-5, **kw)

    @staticmethod
    def tiny(vocab_size: int, **kw) -> "EncoderConfig":
        """Test-size config."""
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position", 320)
        return EncoderConfig(vocab_size=vocab_size, **kw)


def init_encoder_params(gen: torch.Generator, cfg: EncoderConfig) -> dict:
    """Truncated normal (+-2 sigma) times ``initializer_range`` for tables
    and kernels, zero biases, unit LN scales -- the JAX init's
    distribution (torch draws other numbers from a seed).  f32, on the
    generator's device."""
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    dev = gen.device

    def tn(*shape):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return t.mul_(cfg.initializer_range)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    emb = {
        "word": tn(cfg.vocab_size, h),
        "position": tn(cfg.max_position, h),
        "type": tn(max(cfg.type_vocab_size, 1), h),
        "ln_scale": ones(h),
        "ln_bias": zeros(h),
    }
    layers = {
        "qkv_kernel": tn(L, h, 3 * h),
        "qkv_bias": zeros(L, 3 * h),
        "attn_out_kernel": tn(L, h, h),
        "attn_out_bias": zeros(L, h),
        "attn_ln_scale": ones(L, h),
        "attn_ln_bias": zeros(L, h),
        "ffn_in_kernel": tn(L, h, i),
        "ffn_in_bias": zeros(L, i),
        "ffn_out_kernel": tn(L, i, h),
        "ffn_out_bias": zeros(L, h),
        "ffn_ln_scale": ones(L, h),
        "ffn_ln_bias": zeros(L, h),
    }
    return {"embeddings": emb, "layers": layers}


def _embed(params: dict, input_ids: torch.Tensor,
           token_type_ids: Optional[torch.Tensor], cfg: EncoderConfig,
           position_ids: Optional[torch.Tensor] = None,
           seed: Optional[int] = None) -> torch.Tensor:
    """Word + position + token-type embeddings, LayerNorm, dropout in
    training (``seed`` set), cast to the compute dtype.  ``position_ids``
    (b, s) overrides the iota positions (example packing restarts them
    per segment)."""
    emb = params["embeddings"]
    s = input_ids.shape[1]
    ids = input_ids.long()
    x = emb["word"][ids]
    if position_ids is None:
        pos = torch.arange(s, device=ids.device) + cfg.position_offset
        x = x + emb["position"][pos][None, :, :]
    else:
        x = x + emb["position"][position_ids.long() + cfg.position_offset]
    if token_type_ids is not None and cfg.type_vocab_size > 0:
        x = x + emb["type"][token_type_ids.long()]
    else:
        x = x + emb["type"][0][None, None, :]
    x = layer_norm(x, emb["ln_scale"], emb["ln_bias"], cfg.layer_norm_eps)
    if seed is not None:
        x = dropout(x, cfg.hidden_dropout,
                    generator(fold_in(seed, 0xE), x.device))
    return x.to(cfg.cdtype)


def attn_lanes_ok(cfg: EncoderConfig) -> bool:
    """JAX's lane rule for the attention megakernels
    (``encoder.py:322-323``)."""
    return cfg.hidden_size % 128 == 0 and cfg.head_dim % 64 == 0


def attn_kernels_take(cfg: EncoderConfig) -> bool:
    """The lanes hold and the port's attention kernels take the head
    dim."""
    return attn_lanes_ok(cfg) and cfg.head_dim in HEAD_DIMS


def attn_train_routes(cfg: EncoderConfig, seq: int) -> bool:
    """JAX trains this layer's attention block through its megakernel."""
    from ..ops.fused_attention import FAB_MAX_SEQ

    return cfg.use_fused_attn and attn_lanes_ok(cfg) and seq <= FAB_MAX_SEQ


def attn_kernel_routes(cfg: EncoderConfig, seq: int) -> bool:
    """The bf16 attention-block kernel chain takes this eval layer."""
    return (cfg.use_fused_attn_eval and attn_train_routes(cfg, seq)
            and attn_kernels_take(cfg))


def int8_attn_kernel_routes(cfg: EncoderConfig, seq: int) -> bool:
    """The int8 attention-block kernel chain takes a quantized layer."""
    from ..ops.int8_serving import I8_MAX_SEQ

    return (cfg.use_fused_attn and attn_kernels_take(cfg)
            and seq <= I8_MAX_SEQ)


def ffn_kernel_routes(cfg: EncoderConfig) -> bool:
    return (cfg.use_fused_ffn and cfg.hidden_size % 128 == 0
            and cfg.intermediate_size % 128 == 0)


def _refuse_unported_training(cfg: EncoderConfig, seq: int) -> None:
    """Raise where JAX would train through a kernel the port lacks."""
    where = "(ROADMAP.md, queue 2)"
    attn_routes = attn_train_routes(cfg, seq)
    if attn_routes and not attn_kernels_take(cfg):
        raise NotImplementedError(
            f"training with use_fused_attn at head dim {cfg.head_dim}: JAX "
            "routes it to the attention megakernel, whose port takes head "
            f"dims {HEAD_DIMS} {where}; set use_fused_attn=False to train "
            "the plain attention path")
    if attn_routes and cfg.use_int8_train_attn:
        raise NotImplementedError(
            "training with use_int8_train_attn: the int8 attention training "
            f"kernels (fused_attention.py:436, :565) are not ported yet "
            f"{where}")
    if (not attn_routes and cfg.use_flash_attention
            and seq >= cfg.flash_min_seq):
        raise NotImplementedError(
            f"training with use_flash_attention at seq {seq} >= "
            f"flash_min_seq {cfg.flash_min_seq}: the flash kernels are not "
            f"ported yet {where}")
    if ffn_kernel_routes(cfg) and (cfg.use_int8_train
                                   or cfg.use_int8_train_bwd):
        raise NotImplementedError(
            f"training with use_int8_train: the int8 FFN training kernels "
            f"(fused_ffn.py:404, :533) are not ported yet {where}")
    for flag in ("use_fused_ln", "use_fused_gelu", "use_fused_embedding"):
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"training with {flag}: that Pallas kernel is not ported "
                f"yet {where}")


def _qdense(x: torch.Tensor, kernel, bias: torch.Tensor,
            cdt: torch.dtype) -> torch.Tensor:
    """dense() that also takes an int8-quantized {"q", "scale"} leaf
    (``encoder.py:303-310``)."""
    if is_quantized(kernel):
        return dense_int8(x, kernel["q"], kernel["scale"], bias)
    return dense(x, kernel.to(cdt), bias)


def _layer_slice(leaf, layer: int):
    if is_quantized(leaf):
        return {k: v[layer] for k, v in leaf.items()}
    return leaf[layer]


def encoder_forward(params: dict, input_ids: torch.Tensor,
                    attn_mask: torch.Tensor,
                    token_type_ids: Optional[torch.Tensor],
                    cfg: EncoderConfig, *, deterministic: bool = True,
                    seed: Optional[int] = None,
                    position_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Returns the final hidden states (b, s, h) in the compute dtype.
    ``attn_mask`` has SEGMENT semantics (see ``ops/attention.py``).
    ``deterministic=False`` trains: dropout on, keyed on ``seed``."""
    train = not deterministic
    if train:
        if seed is None:
            raise ValueError("encoder_forward: deterministic=False requires "
                             "a seed")
        _refuse_unported_training(cfg, input_ids.shape[1])
    x = _embed(params, input_ids, token_type_ids, cfg,
               position_ids=position_ids, seed=seed if train else None)
    b, s, h = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    cdt = cfg.cdtype
    lp = params["layers"]
    if train:
        attn_route = "bf16" if attn_train_routes(cfg, s) else None
    elif is_quantized(lp["qkv_kernel"]):
        attn_route = "int8" if int8_attn_kernel_routes(cfg, s) else None
    else:
        attn_route = "bf16" if attn_kernel_routes(cfg, s) else None
    ffn_route = None
    if ffn_kernel_routes(cfg):
        ffn_route = "int8" if is_quantized(lp["ffn_in_kernel"]) else "bf16"
        if train and ffn_route == "int8":
            ffn_route = None            # serving-only kernels, as in JAX
    if attn_route == "bf16":
        from ..ops.fused_attention import fused_attention_block
    if ffn_route == "bf16":
        from ..ops.fused_ffn import fused_ffn_block
    if "int8" in (attn_route, ffn_route):
        from ..ops.int8_serving import int8_attention_block, int8_ffn_block

    def gen(lseed: int, site: int):
        return generator(fold_in(lseed, site), x.device)

    hidden_rate = cfg.hidden_dropout if train else 0.0
    for layer in range(cfg.num_layers):
        p = {k: _layer_slice(v, layer) for k, v in lp.items()}
        lseed = fold_in(seed, layer) if train else None

        if attn_route == "int8":
            wqkv, wo = p["qkv_kernel"], p["attn_out_kernel"]
            x = int8_attention_block(
                x, wqkv["q"], wqkv["scale"], p["qkv_bias"], wo["q"],
                wo["scale"], p["attn_out_bias"], p["attn_ln_scale"],
                p["attn_ln_bias"], attn_mask, n_heads=nh,
                eps=cfg.layer_norm_eps)
        elif attn_route == "bf16":
            x = fused_attention_block(
                x, p["qkv_kernel"].to(cdt), p["qkv_bias"],
                p["attn_out_kernel"].to(cdt), p["attn_out_bias"],
                p["attn_ln_scale"], p["attn_ln_bias"], attn_mask,
                n_heads=nh, attn_dropout=cfg.attn_dropout if train else 0.0,
                hidden_dropout=hidden_rate,
                seed=fold_in(lseed, 1) if train else None,
                eps=cfg.layer_norm_eps)
        else:
            qkv = _qdense(x, p["qkv_kernel"], p["qkv_bias"], cdt)
            q, k, v = qkv.split(h, dim=-1)
            ctx = multi_head_attention(
                q.reshape(b, s, nh, hd), k.reshape(b, s, nh, hd),
                v.reshape(b, s, nh, hd), attn_mask,
                dropout_rate=cfg.attn_dropout,
                gen=gen(lseed, 1) if train else None,
                deterministic=deterministic).reshape(b, s, h)
            ctx = _qdense(ctx, p["attn_out_kernel"], p["attn_out_bias"], cdt)
            if train:
                ctx = dropout(ctx, hidden_rate, gen(lseed, 2))
            x = layer_norm(x + ctx, p["attn_ln_scale"], p["attn_ln_bias"],
                           cfg.layer_norm_eps)

        if ffn_route == "int8":
            w1, w2 = p["ffn_in_kernel"], p["ffn_out_kernel"]
            x = int8_ffn_block(
                x, w1["q"], w1["scale"], p["ffn_in_bias"], w2["q"],
                w2["scale"], p["ffn_out_bias"], p["ffn_ln_scale"],
                p["ffn_ln_bias"], eps=cfg.layer_norm_eps)
        elif ffn_route == "bf16":
            x = fused_ffn_block(
                x, p["ffn_in_kernel"].to(cdt), p["ffn_in_bias"],
                p["ffn_out_kernel"].to(cdt), p["ffn_out_bias"],
                p["ffn_ln_scale"], p["ffn_ln_bias"],
                dropout_rate=hidden_rate,
                seed=fold_in(lseed, 3) if train else None,
                eps=cfg.layer_norm_eps)
        else:
            y = gelu(_qdense(x, p["ffn_in_kernel"], p["ffn_in_bias"], cdt))
            y = _qdense(y, p["ffn_out_kernel"], p["ffn_out_bias"], cdt)
            if train:
                y = dropout(y, hidden_rate, gen(lseed, 3))
            x = layer_norm(x + y, p["ffn_ln_scale"], p["ffn_ln_bias"],
                           cfg.layer_norm_eps)
    return x
