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
a multiple of 128 and a head dim a multiple of 64 (``attn_lanes_ok``):

- a quantized QKV kernel sends the attention block to
  ``ops.int8_serving.int8_attention_block`` when ``use_fused_attn`` is
  set, the lanes hold and seq <= 512 (``use_fused_attn_eval`` is not
  needed, as in JAX); a tensor one to ``ops.fused_attention`` when
  ``use_fused_attn`` and ``use_fused_attn_eval`` are set, the lanes hold
  and seq <= 512;
- the FFN block goes to ``ops.int8_serving.int8_ffn_block`` (quantized
  leaves) or ``ops.fused_ffn`` (tensor leaves) when ``use_fused_ffn`` is
  set and hidden and intermediate are multiples of 128;
- otherwise the plain path runs, exactly as the JAX XLA path does, with
  ``qdense`` taking either kind of leaf -- with JAX's three fused row
  kernels where its flags send them, in eval and in training:
  ``use_fused_ln`` puts both residual LayerNorms of the plain attention and
  FFN paths on ``ops.fused_ln.fused_residual_layer_norm`` (the residual sum
  in f32, ``encoder.py:292-301``), ``use_fused_gelu`` computes the plain
  FFN's first GEMM without its bias, accumulated in f32 and rounded once,
  and adds the bias in ``ops.fused_gelu.fused_bias_gelu``
  (``encoder.py:445-450``; a quantized FFN kernel keeps the plain int8
  dense, which JAX cannot run with this flag), and ``use_fused_embedding``
  sends the embeddings to ``ops.fused_embed.fused_embed_lookup`` whenever
  no ``position_ids`` are given (``encoder.py:176-186``).

Out-of-range ids follow JAX on each path: the plain embedding gathers as
XLA does, clamping word, type and position indices into their tables and
dropping their gradients (``layers.take_rows``); the fused lookup reads a
zero row for a type id outside its table and for a word id in the
table's padding to a multiple of 8, as JAX's one-hot selects do
(``ops/fused_embed.py``).

Training (``deterministic=False``) needs an explicit ``seed``; every
dropout site takes its own seed from it with ``philox.fold_in`` (per
layer, then per site: 1 attention probs, 2 attention hidden, 3 FFN, and
0xE the embeddings -- the JAX ``fold_in`` structure, ``encoder.py:201,
315, 366-441``).  The attention block routes to ``ops.fused_attention``
(the kernel chains, Philox streams 3 and 4 under the one site-1 seed, as
JAX's ``fold_in(lrng, 1)`` covers the whole block) where JAX routes it
to its megakernel: ``use_fused_attn``, the lanes and seq <= 512
(``attn_train_routes``) -- through ``fused_attention_block_int8_train``
when ``use_int8_train_attn`` is set (``encoder.py:354-368``), else
``fused_attention_block``; otherwise it runs the plain path with
probability and hidden dropout, whose attention takes the flash route
(``ops.flash_attention``: ``seg_attention`` / ``seg_attention_bwd`` up to
seq 512, the tiled flash kernels above) exactly where JAX's
``multi_head_attention`` takes its flash kernels -- ``use_flash_attention``,
seq >= the effective ``flash_min_seq`` (``NBEST_FLASH_MIN_SEQ`` wins when
set) and ``_flash_preferred`` (``ops/attention.py``) -- with the Philox
stream-3 mask under the site-1 seed.  The FFN block routes to ``ops.fused_ffn``
when ``use_fused_ffn`` and the lanes hold -- through
``fused_ffn_block_int8_train`` when ``use_int8_train`` is set
(``encoder.py:420-432``), else ``fused_ffn_block`` -- and otherwise runs
the plain FFN with ``layers.dropout``.  ``use_int8_train_bwd`` selects the
int8-dgrad backward of whichever block took its int8 route, and does
nothing elsewhere, as in JAX.  ``remat`` runs each training layer under a
non-reentrant ``torch.utils.checkpoint`` (``_run_layer``), on every route
and under tensor parallelism, as JAX's ``jax.checkpoint`` of its layer
step.

The attention kernels take every head dim JAX runs (d >= 1): the
megakernel route and both flash routes run the fixed-width instances at
d <= 256 with d % 8 == 0 and the chunked family at every other d
(``ops.kernels.chunked_head_dim``), so the port refuses no head dim that
JAX trains or serves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.attention import flash_routes, multi_head_attention
from ..ops.layers import (acc_dtype, dense, dropout, gelu, layer_norm,
                          take_rows, take_rows_shard)
from ..ops.philox import fold_in, generator
from ..ops.quant import dense_int8, is_quantized

GEMM_KERNELS = ("qkv_kernel", "attn_out_kernel", "ffn_in_kernel",
                "ffn_out_kernel")


@dataclass(frozen=True)
class EncoderConfig:
    """Same fields and defaults as the JAX ``EncoderConfig``.  The port
    reads the sizes, dropout rates, ``compute_dtype``, the routing flags
    ``use_fused_attn``, ``use_fused_attn_eval`` and ``use_fused_ffn``, and
    in training ``use_flash_attention`` with ``flash_min_seq`` and the int8
    flags ``use_int8_train``, ``use_int8_train_attn`` and
    ``use_int8_train_bwd``, and in eval and training ``use_fused_ln``,
    ``use_fused_gelu`` and ``use_fused_embedding`` (module docstring);
    and in training ``remat`` (``_run_layer``); ``scan_unroll`` steers the
    TPU's scan and is kept so one configuration describes both
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
           seed: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Word + position + token-type embeddings, LayerNorm, dropout in
    training (``seed`` set), cast to the compute dtype.  ``position_ids``
    (b, s) overrides the iota positions (example packing restarts them
    per segment); without them ``use_fused_embedding`` runs the fused
    lookup.  Under tensor parallelism (``mesh``) the word rows come from
    the vocab-parallel table."""
    emb = params["embeddings"]
    s = input_ids.shape[1]
    has_types = token_type_ids is not None and cfg.type_vocab_size > 0
    if mesh is not None:
        x = _embed_plain(emb, input_ids.long(),
                         token_type_ids if has_types else None, cfg,
                         position_ids, mesh)
    elif cfg.use_fused_embedding and position_ids is None:
        from ..ops.fused_embed import fused_embed_lookup

        # JAX's dynamic_slice_in_dim clamps the start so the slice fits
        off = max(0, min(cfg.position_offset, emb["position"].shape[0] - s))
        x = fused_embed_lookup(emb["word"], emb["position"][off:off + s],
                               emb["type"], emb["ln_scale"], emb["ln_bias"],
                               input_ids, token_type_ids if has_types
                               else None, s, cfg.layer_norm_eps)
    else:
        x = _embed_plain(emb, input_ids.long(),
                         token_type_ids if has_types else None, cfg,
                         position_ids)
    if seed is not None:
        x = dropout(x, cfg.hidden_dropout,
                    generator(fold_in(seed, 0xE), x.device))
    return x.to(cfg.cdtype)


def _embed_plain(emb: dict, ids: torch.Tensor,
                 token_type_ids: Optional[torch.Tensor], cfg: EncoderConfig,
                 position_ids: Optional[torch.Tensor],
                 mesh=None) -> torch.Tensor:
    s = ids.shape[1]
    if mesh is None:
        x = take_rows(emb["word"], ids)
    else:
        from ..parallel.mesh import reduce_from_tp

        shard = emb["word"]
        x = reduce_from_tp(take_rows_shard(
            shard, ids, cfg.vocab_size, mesh.tp_rank * shard.shape[0]),
            mesh)
    if position_ids is None:
        pos = torch.arange(s, device=ids.device) + cfg.position_offset
        x = x + take_rows(emb["position"], pos)[None, :, :]
    else:
        x = x + take_rows(emb["position"],
                          position_ids.long() + cfg.position_offset)
    if token_type_ids is not None:
        x = x + take_rows(emb["type"], token_type_ids)
    else:
        x = x + emb["type"][0][None, None, :]
    return layer_norm(x, emb["ln_scale"], emb["ln_bias"], cfg.layer_norm_eps)


def attn_lanes_ok(cfg: EncoderConfig) -> bool:
    """JAX's lane rule for the attention megakernels
    (``encoder.py:322-323``)."""
    return cfg.hidden_size % 128 == 0 and cfg.head_dim % 64 == 0


def attn_train_routes(cfg: EncoderConfig, seq: int) -> bool:
    """JAX trains this layer's attention block through its megakernel."""
    from ..ops.fused_attention import FAB_MAX_SEQ

    return cfg.use_fused_attn and attn_lanes_ok(cfg) and seq <= FAB_MAX_SEQ


def attn_kernel_routes(cfg: EncoderConfig, seq: int) -> bool:
    """JAX runs this eval layer's attention block on its bf16 megakernel."""
    return cfg.use_fused_attn_eval and attn_train_routes(cfg, seq)


def int8_attn_kernel_routes(cfg: EncoderConfig, seq: int) -> bool:
    """JAX runs this quantized layer's attention block on its int8
    serving megakernel."""
    from ..ops.int8_serving import I8_MAX_SEQ

    return cfg.use_fused_attn and attn_lanes_ok(cfg) and seq <= I8_MAX_SEQ


def ffn_kernel_routes(cfg: EncoderConfig) -> bool:
    return (cfg.use_fused_ffn and cfg.hidden_size % 128 == 0
            and cfg.intermediate_size % 128 == 0)


def flash_train_routes(cfg: EncoderConfig, batch: int, seq: int) -> bool:
    """JAX's ``multi_head_attention`` takes the flash kernels for this
    training layer on its plain attention path."""
    itemsize = torch.finfo(cfg.cdtype).bits // 8
    return flash_routes((batch, seq, cfg.num_heads), itemsize,
                        use_flash=cfg.use_flash_attention,
                        deterministic=False,
                        flash_min_seq=cfg.flash_min_seq)


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


def _tp_row_dense(x: torch.Tensor, kernel: torch.Tensor,
                  bias: torch.Tensor, cdt: torch.dtype, mesh
                  ) -> torch.Tensor:
    """``dense`` of a row-parallel kernel shard: the partial product in
    f32, one ``all_reduce`` over tp, then the bias, added once after the
    sum (not on every rank), and one rounding to the compute dtype."""
    from ..parallel.mesh import reduce_from_tp

    acc = acc_dtype(cdt)
    y = reduce_from_tp(torch.matmul(x.to(acc), kernel.to(cdt).to(acc)),
                       mesh)
    return (y + bias.to(acc)).to(cdt)


def _tp_layer(x: torch.Tensor, p: dict, attn_mask: torch.Tensor,
              cfg: EncoderConfig, mesh, lseed: Optional[int]
              ) -> torch.Tensor:
    """One layer on the plain route under tensor parallelism
    (``parallel/mesh.py``): column-parallel QKV on this rank's heads and
    W1 on its columns, row-parallel out-proj and W2.  Dropout: the
    replicated sites (attention out-proj, FFN output) draw the same mask
    on every tp rank; the attention probs, sharded by head, fold the
    rank's first global head into their seed."""
    from ..parallel.mesh import copy_to_tp

    b, s, _ = x.shape
    cdt, T = cfg.cdtype, mesh.tp_size
    nhl, hd = cfg.num_heads // T, cfg.head_dim
    hl = nhl * hd
    train = lseed is not None
    rate = cfg.hidden_dropout if train else 0.0

    def gen(*site):
        return generator(fold_in(lseed, *site), x.device) if train else None

    qkv = dense(copy_to_tp(x, mesh), p["qkv_kernel"].to(cdt), p["qkv_bias"])
    q, k, v = qkv.split(hl, dim=-1)
    ctx = multi_head_attention(
        q.reshape(b, s, nhl, hd), k.reshape(b, s, nhl, hd),
        v.reshape(b, s, nhl, hd), attn_mask, dropout_rate=cfg.attn_dropout,
        gen=gen(1, mesh.tp_rank * nhl), deterministic=not train
    ).reshape(b, s, hl)
    ctx = _tp_row_dense(ctx, p["attn_out_kernel"], p["attn_out_bias"], cdt,
                        mesh)
    if train:
        ctx = dropout(ctx, rate, gen(2))
    x = layer_norm(x + ctx, p["attn_ln_scale"], p["attn_ln_bias"],
                   cfg.layer_norm_eps)
    y = gelu(dense(copy_to_tp(x, mesh), p["ffn_in_kernel"].to(cdt),
                   p["ffn_in_bias"]))
    y = _tp_row_dense(y, p["ffn_out_kernel"], p["ffn_out_bias"], cdt, mesh)
    if train:
        y = dropout(y, rate, gen(3))
    return layer_norm(x + y, p["ffn_ln_scale"], p["ffn_ln_bias"],
                      cfg.layer_norm_eps)


def _run_layer(body, x: torch.Tensor, layer: int, remat: bool
               ) -> torch.Tensor:
    """``body(x, layer)``; under ``remat`` inside a non-reentrant
    ``torch.utils.checkpoint``, which keeps only ``x`` and re-runs the
    layer's forward in the backward (JAX's ``jax.checkpoint`` of the layer
    step, ``encoder.py:462-464``).  The recompute draws the same dropout
    masks: every site's generator is made inside ``body`` from the
    layer's seed, and the kernels' Philox keep bits are keyed on (seed,
    element), so nothing depends on a generator's state between the two
    runs."""
    if not remat:
        return body(x, layer)
    from torch.utils.checkpoint import checkpoint

    # no route draws from the default generators (``layers.dropout``
    # refuses a missing one), so saving and restoring their states around
    # each layer's forward and recompute would be work for nothing
    return checkpoint(body, x, layer, use_reentrant=False,
                      preserve_rng_state=False)


def encoder_forward(params: dict, input_ids: torch.Tensor,
                    attn_mask: torch.Tensor,
                    token_type_ids: Optional[torch.Tensor],
                    cfg: EncoderConfig, *, deterministic: bool = True,
                    seed: Optional[int] = None,
                    position_ids: Optional[torch.Tensor] = None,
                    mesh=None) -> torch.Tensor:
    """Returns the final hidden states (b, s, h) in the compute dtype.
    ``attn_mask`` has SEGMENT semantics (see ``ops/attention.py``).
    ``deterministic=False`` trains: dropout on, keyed on ``seed``.

    ``mesh`` (``parallel/mesh.py``) with tp > 1 takes ``params`` as this
    rank's shards and runs every layer on the plain route with the
    Megatron pairing (``_tp_layer``), and the embeddings on the
    vocab-parallel table: no hand kernel runs, whatever the kernel flags
    say (ROADMAP queue 2 item 2: they stay off until a sharded kernel
    test exists)."""
    train = not deterministic
    if train and seed is None:
        raise ValueError("encoder_forward: deterministic=False requires "
                         "a seed")
    lp = params["layers"]
    if mesh is not None and mesh.tp_size > 1:
        T = mesh.tp_size
        if cfg.num_heads % T or cfg.intermediate_size % T:
            raise ValueError(
                f"tensor parallelism {T} needs num_heads "
                f"({cfg.num_heads}) and intermediate_size "
                f"({cfg.intermediate_size}) divisible by it")
        if any(is_quantized(v) for v in lp.values()):
            raise NotImplementedError("int8-quantized leaves under tensor "
                                      "parallelism")
        x = _embed(params, input_ids, token_type_ids, cfg,
                   position_ids=position_ids, seed=seed if train else None,
                   mesh=mesh)

        def tp_body(x: torch.Tensor, layer: int) -> torch.Tensor:
            return _tp_layer(x, {k: v[layer] for k, v in lp.items()},
                             attn_mask, cfg, mesh,
                             fold_in(seed, layer) if train else None)

        for layer in range(cfg.num_layers):
            x = _run_layer(tp_body, x, layer, train and cfg.remat)
        return x
    x = _embed(params, input_ids, token_type_ids, cfg,
               position_ids=position_ids, seed=seed if train else None)
    b, s, h = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    cdt = cfg.cdtype
    if train:
        attn_route = None
        if attn_train_routes(cfg, s):
            attn_route = "int8_train" if cfg.use_int8_train_attn else "bf16"
    elif is_quantized(lp["qkv_kernel"]):
        attn_route = "int8" if int8_attn_kernel_routes(cfg, s) else None
    else:
        attn_route = "bf16" if attn_kernel_routes(cfg, s) else None
    ffn_route = None
    if ffn_kernel_routes(cfg):
        if is_quantized(lp["ffn_in_kernel"]):
            # serving-only kernels, as in JAX
            ffn_route = None if train else "int8"
        else:
            ffn_route = "int8_train" if train and cfg.use_int8_train \
                else "bf16"
    if attn_route == "bf16":
        from ..ops.fused_attention import fused_attention_block
    if attn_route == "int8_train":
        from ..ops.fused_attention import fused_attention_block_int8_train
    if ffn_route == "bf16":
        from ..ops.fused_ffn import fused_ffn_block
    if ffn_route == "int8_train":
        from ..ops.fused_ffn import fused_ffn_block_int8_train
    if "int8" in (attn_route, ffn_route):
        from ..ops.int8_serving import int8_attention_block, int8_ffn_block
    if cfg.use_fused_ln:
        from ..ops.fused_ln import fused_residual_layer_norm

        def res_ln(delta, residual, scale, bias):
            return fused_residual_layer_norm(delta, residual, scale, bias,
                                             cfg.layer_norm_eps)
    else:
        def res_ln(delta, residual, scale, bias):
            return layer_norm(residual + delta, scale, bias,
                              cfg.layer_norm_eps)
    if cfg.use_fused_gelu:
        from ..ops.fused_gelu import fused_bias_gelu

    def gen(lseed: int, site: int):
        return generator(fold_in(lseed, site), x.device)

    hidden_rate = cfg.hidden_dropout if train else 0.0

    def layer_body(x: torch.Tensor, layer: int) -> torch.Tensor:
        # the layer's slices and seeds are taken here, so that a
        # remat recompute takes them again
        p = {k: _layer_slice(v, layer) for k, v in lp.items()}
        lseed = fold_in(seed, layer) if train else None

        if attn_route == "int8":
            wqkv, wo = p["qkv_kernel"], p["attn_out_kernel"]
            x = int8_attention_block(
                x, wqkv["q"], wqkv["scale"], p["qkv_bias"], wo["q"],
                wo["scale"], p["attn_out_bias"], p["attn_ln_scale"],
                p["attn_ln_bias"], attn_mask, n_heads=nh,
                eps=cfg.layer_norm_eps)
        elif attn_route == "int8_train":
            x = fused_attention_block_int8_train(
                x, p["qkv_kernel"].to(cdt), p["qkv_bias"],
                p["attn_out_kernel"].to(cdt), p["attn_out_bias"],
                p["attn_ln_scale"], p["attn_ln_bias"], attn_mask,
                n_heads=nh, attn_dropout=cfg.attn_dropout,
                hidden_dropout=hidden_rate, seed=fold_in(lseed, 1),
                eps=cfg.layer_norm_eps, int8_bwd=cfg.use_int8_train_bwd)
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
                seed=fold_in(lseed, 1) if train else None,
                deterministic=deterministic,
                use_flash=cfg.use_flash_attention,
                flash_min_seq=cfg.flash_min_seq).reshape(b, s, h)
            ctx = _qdense(ctx, p["attn_out_kernel"], p["attn_out_bias"], cdt)
            if train:
                ctx = dropout(ctx, hidden_rate, gen(lseed, 2))
            x = res_ln(ctx, x, p["attn_ln_scale"], p["attn_ln_bias"])

        if ffn_route == "int8":
            w1, w2 = p["ffn_in_kernel"], p["ffn_out_kernel"]
            x = int8_ffn_block(
                x, w1["q"], w1["scale"], p["ffn_in_bias"], w2["q"],
                w2["scale"], p["ffn_out_bias"], p["ffn_ln_scale"],
                p["ffn_ln_bias"], eps=cfg.layer_norm_eps)
        elif ffn_route == "int8_train":
            x = fused_ffn_block_int8_train(
                x, p["ffn_in_kernel"].to(cdt), p["ffn_in_bias"],
                p["ffn_out_kernel"].to(cdt), p["ffn_out_bias"],
                p["ffn_ln_scale"], p["ffn_ln_bias"],
                dropout_rate=hidden_rate, seed=fold_in(lseed, 3),
                eps=cfg.layer_norm_eps, int8_bwd=cfg.use_int8_train_bwd)
        elif ffn_route == "bf16":
            x = fused_ffn_block(
                x, p["ffn_in_kernel"].to(cdt), p["ffn_in_bias"],
                p["ffn_out_kernel"].to(cdt), p["ffn_out_bias"],
                p["ffn_ln_scale"], p["ffn_ln_bias"],
                dropout_rate=hidden_rate,
                seed=fold_in(lseed, 3) if train else None,
                eps=cfg.layer_norm_eps)
        else:
            w1 = p["ffn_in_kernel"]
            if cfg.use_fused_gelu and not is_quantized(w1):
                acc = acc_dtype(cdt)
                y = torch.matmul(x.to(acc), w1.to(cdt).to(acc)).to(cdt)
                y = fused_bias_gelu(y, p["ffn_in_bias"])
            else:
                y = gelu(_qdense(x, w1, p["ffn_in_bias"], cdt))
            y = _qdense(y, p["ffn_out_kernel"], p["ffn_out_bias"], cdt)
            if train:
                y = dropout(y, hidden_rate, gen(lseed, 3))
            x = res_ln(y, x, p["ffn_ln_scale"], p["ffn_ln_bias"])
        return x

    for layer in range(cfg.num_layers):
        x = _run_layer(layer_body, x, layer, train and cfg.remat)
    return x
