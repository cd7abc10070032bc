#!/usr/bin/env python3
"""Time the port's attention kernels, its int8 and bf16 GEMMs and its
bias-GELU kernels of one checkout on one NVIDIA GPU, so that two commits
can be compared on the same card:

    python3 chip_time_attention.py [--root CHECKOUT] [--iters N]
                                   [--only GROUP,...]

``--root`` is the root of a checkout of this repository (default: the
directory of this script); its ``nbest_asr_tpu_torch`` is imported and
its kernels are built into its own ``build/``.  BERT-base widths (hidden
768, 12 heads), bf16, a padded mask from a fixed seed.  Prints one JSON
line: ``seg_attention`` ms per call at batch 64 x seq {64, 96, 160, 256}
(the serving forward), and, where the checkout has the training kernels,
``seg_attention`` with prob dropout and row statistics and
``seg_attention_bwd`` at 8192 rows (32 x 256) with dropout and without,
and ``seg_attention`` so at
16 x 512, each as ``[back to back, device]`` ms (below); then
``train_bwd_times``: ``seg_attention_bwd`` at every bucket's training
micro, on route A's layout and past 256 keys (16 x 512, 24 x 300, 21 x
384), SDPA
beside it, the d = 128 attention pair with SDPA beside it and
``layer_norm_rows`` beside ``F.layer_norm``; ``head_dim_times``: the
single-block pair at d = 96 (8 heads) and at d = 192 (4 heads) at every
bucket's training micro, with dropout and statistics, SDPA's
forward and backward alone beside it (``d96_ms``, ``d192_ms``; at d = 192
also past 256 keys: 16 x 512 padded and packed, 24 x 300, 4 x 300); and,
where it has
them,
``quantize_rows`` of a (64 x 256, 768) and a (64 x 256, 3072) bf16 block
input and its four launches of a layer, and the four
int8 serving GEMM launches of a layer at 64 x 256 rows
(``gemm_i8_bias_act`` QKV and W1 + GELU, ``gemm_i8_bias_residual``
out-proj and W2), each as ``[back to back, device]`` ms, and
``train_i8_ms``: the int8 training launches of a layer at 8192 rows
(the four ``quantize_rows``; the four ``quantize_grad_rows``, together and
each alone: drop2(ds) and drop_h(ds) f32 at 768 with the stream-2 and
stream-4 dropout, dh f32 at 3072, dqkv bf16 at 2304; ``gemm_i8_dgrad``
dgelu with dropout, residual, none, residual;
``gemm_i8_bias_act`` W1 + GELU with dropout and h saved, and QKV;
``gemm_i8_bias_residual`` W2 with dropout and y2d saved, and the out-proj
with the hidden dropout and od saved), ``torch._int_mm`` on the two
residual launches' operands and on the four dgrads' operands, the weight
given as the transposed view and as a contiguous transpose made
beforehand, and
``encoder_fwd_ms``: the 12-layer BERT-base encoder forward (seed-0
weights, both megakernel flags) at 64 x 256 in bf16 and in int8, the
serving forward without the head; where it has the tiled flash kernels,
``flash_ms``: ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` at
batch 32 x seq 1024 on q, k, v views of one QKV buffer with a padded mask
and prob dropout, the three again without dropout, and SDPA's forward and
its backward alone (autograd.grad over a retained forward, the same
operands, mask and dropout rate), each as ``[back to back, device]`` ms,
and ``flash_d96_ms``: the same at 8 heads of 96 at 32 x 1024 and 48 x
1024 (the quality tools' encoder);
and
``gemm_ms``, each bf16 GEMM
launch of an encoder layer: the four ``gemm_dgrad`` launches of a training
layer at 8192 rows (dgelu with dropout, residual, none, residual; and the
dgelu launch without dropout and with the "none" epilogue), the two
``gemm_bias_residual`` launches at 8192 rows with dropout and y2d saved and
at 64 x 256 rows for serving, and ``gemm_bias_act``'s two launches in each,
each as ``[back to back, device]`` ms; and ``rows_ms``: ``bias_gelu``
and ``bias_gelu_bwd`` at 8192 x 3072 bf16 beside ``F.gelu(x + b)`` and
autograd's GELU backward, and ``embed_lookup`` at 8192 tokens (f32
tables) at BERT's vocab and at XLM-R's with out-of-range type and word
ids, each as ``[back to back, device]`` ms; and ``embed_ms``: the plain
embedding's forward and backward at a training micro of 128 x 64, the
12-layer encoder's training forward and backward there and its serving
forward at 64 x 64, each as ``[back to back, device]`` ms; and
``chunked_ms``: the chunked family at 32 x 256 x 2 heads of 384 and at
32 x 256 and 32 x 1024 x 64 heads of 12 (``CHUNKED_SHAPES``), its
forward and backward beside SDPA's forward: back to
back times
the calls as the host issues them, device queues them behind a sleep so
that the card runs them without waiting for the host.  With the card's
name and power limit.  CUDA events over ``--iters`` calls after two
warm-up calls; ``--only`` times some of the groups (GROUPS), as when
comparing variant checkouts of one kernel.  Run two checkouts alternately (A B B A) in one call to
compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

H, NH = 768, 12
# the timed groups (--only): the seg_attention launches and the training
# attention times, the int8 launches and encoder forwards, the tiled flash
# kernels (d = 64 and 96), the bf16 GEMMs, the bias-GELU pair and the
# embedding lookup, the plain embedding and the encoder around it, the
# chunked family at the head dims no fixed-width instance takes
GROUPS = ("attention", "int8", "flash", "gemm", "rows", "embed", "chunked")


def cuda_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def device_ms(fn, iters: int) -> float:
    """Per-call device time: the calls queue behind a ~0.1 s sleep, so the
    card runs them back to back however slowly the host issues them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def both_ms(fn, iters: int) -> list:
    """[back to back, device] ms per call."""
    return [cuda_ms(fn, iters), device_ms(fn, iters)]


def gemm_times(K, dev, gen, iters: int) -> dict:
    """Each bf16 GEMM launch of a BERT-base layer: training at 8192 rows
    (dropout 0.1), serving at 64 x 256 rows; [back to back, device] ms."""
    from nbest_asr_tpu_torch.ops.philox import site

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to(dev, dtype)

    i, h3 = 4 * H, 3 * H
    w1, w2, wo, wqkv = (rn(H, i, std=0.02), rn(i, H, std=0.02),
                        rn(H, H, std=0.02), rn(H, h3, std=0.02))
    b1, b2, bo, bqkv = (rn(n, std=0.02, dtype=torch.float32)
                        for n in (i, H, H, h3))
    d1, d2, dh = site(1, 0.1, 1), site(1, 0.1, 2), site(1, 0.1, 4)
    m = 8192
    x, dy2, dout = rn(m, H), rn(m, H), rn(m, H)
    hh, gd, dhh = rn(m, i), rn(m, i), rn(m, i)
    ctx, dqkv = rn(m, H), rn(m, h3)
    ds = rn(m, H, dtype=torch.float32)
    xs, gs, cs = rn(64 * 256, H), rn(64 * 256, i), rn(64 * 256, H)
    calls = {
        "dgrad_dgelu": lambda: K.gemm_dgrad(dy2, w2, "dgelu", h=hh,
                                            drop=d1),
        # the dgelu launch's epilogue in parts: without dropout, and the
        # product alone at its shape
        "dgrad_dgelu_no_dropout": lambda: K.gemm_dgrad(dy2, w2, "dgelu",
                                                       h=hh),
        "dgrad_none_w2": lambda: K.gemm_dgrad(dy2, w2, "none"),
        "dgrad_residual_w1": lambda: K.gemm_dgrad(dhh, w1, "residual",
                                                  ds=ds),
        "dgrad_none_wo": lambda: K.gemm_dgrad(dout, wo, "none"),
        "dgrad_residual_wqkv": lambda: K.gemm_dgrad(dqkv, wqkv, "residual",
                                                    ds=ds),
        "residual_w2_train": lambda: K.gemm_bias_residual(
            gd, w2, b2, x, drop=d2, save_y2d=True),
        "residual_wo_train": lambda: K.gemm_bias_residual(
            ctx, wo, bo, x, drop=dh, save_y2d=True),
        "residual_wo_serve": lambda: K.gemm_bias_residual(cs, wo, bo, xs),
        "residual_w2_serve": lambda: K.gemm_bias_residual(gs, w2, b2, xs),
        "act_w1_train": lambda: K.gemm_bias_act(x, w1, b1, "gelu", drop=d1,
                                                save_h=True),
        "act_qkv_train": lambda: K.gemm_bias_act(x, wqkv, bqkv),
        "act_qkv_serve": lambda: K.gemm_bias_act(xs, wqkv, bqkv),
        "act_w1_serve": lambda: K.gemm_bias_act(xs, w1, b1, "gelu"),
    }
    return {name: both_ms(fn, iters) for name, fn in calls.items()}


def train_i8_times(K, dev, gen, iters: int) -> dict:
    """The int8 training GEMM launches of a BERT-base layer at 8192 rows
    (``NBEST_BENCH_INT8=2``, dropout 0.1) and ``torch._int_mm`` on the
    dgrads' operands; [back to back, device] ms."""
    from nbest_asr_tpu_torch.ops.philox import site
    from nbest_asr_tpu_torch.ops.quant import quantize_train_weight

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to(dev, dtype)

    i, h3, m = 4 * H, 3 * H, 8192
    (w1q, w1r, w1s), (w2q, w2r, w2s), (woq, wor, wos), (aq, ar, a_s) = (
        quantize_train_weight(rn(k, n, std=0.02))
        for k, n in ((H, i), (i, H), (H, H), (H, h3)))
    b1, bqkv = rn(i, std=0.02, dtype=torch.float32), rn(
        h3, std=0.02, dtype=torch.float32)
    b2, bo = (rn(H, std=0.02, dtype=torch.float32) for _ in range(2))
    d1, d2, dh = site(1, 0.1, 1), site(1, 0.1, 2), site(1, 0.1, 4)
    xq = K.quantize_rows(rn(m, H))
    # the four quantize_rows launches of a layer: x, ctx, x, gd
    xr, cr, gr = rn(m, H), rn(m, H), rn(m, i)
    # the residual launches' quantized inputs (gd, ctx) and residual
    gq, cq, x = (K.quantize_rows(rn(m, i)), K.quantize_rows(rn(m, H)),
                 rn(m, H))
    h = rn(m, i)
    ds = rn(m, H, dtype=torch.float32)
    # the gradients each dgrad contracts, quantized with the weight's
    # scales folded in: drop2(ds) . W2^T, dh . W1^T, drop_h(ds) . Wo^T,
    # dqkv . Wqkv^T
    grads = ((rn(m, H, std=1e-3, dtype=torch.float32), w2s, d2),
             (rn(m, i, std=1e-3, dtype=torch.float32), w1s, None),
             (rn(m, H, std=1e-3, dtype=torch.float32), wos, dh),
             (rn(m, h3, std=1e-3), a_s, None))
    g1, g2, g3, g4 = (K.quantize_grad_rows(*a) for a in grads)
    pairs = ((g1, w2r), (g2, w1r), (g3, wor), (g4, ar))
    contig = [w.t().contiguous() for _, w in pairs]
    calls = {
        "quantize_rows_x4": lambda: [K.quantize_rows(t)
                                     for t in (xr, cr, xr, gr)],
        "quantize_grad_rows_x4": lambda: [K.quantize_grad_rows(*a)
                                          for a in grads],
        # each of the four alone
        **{f"quantize_grad_rows_{name}": (lambda a=a: K.quantize_grad_rows(
            *a)) for name, a in zip(("ds_768_drop", "dh_3072", "ds_768_drop_h",
                                     "dqkv_2304_bf16"), grads)},
        "dgrad_dgelu": lambda: K.gemm_i8_dgrad(*g1, w2r, "dgelu", h=h,
                                               drop=d1),
        "dgrad_residual_w1": lambda: K.gemm_i8_dgrad(*g2, w1r, "residual",
                                                     ds=ds),
        "dgrad_none_wo": lambda: K.gemm_i8_dgrad(*g3, wor, "none"),
        "dgrad_residual_wqkv": lambda: K.gemm_i8_dgrad(*g4, ar, "residual",
                                                       ds=ds),
        "act_w1_train": lambda: K.gemm_i8_bias_act(*xq, w1q, w1s, b1,
                                                   "gelu", drop=d1,
                                                   save_h=True),
        "act_qkv_train": lambda: K.gemm_i8_bias_act(*xq, aq, a_s, bqkv),
        "residual_w2_train": lambda: K.gemm_i8_bias_residual(
            *gq, w2q, w2s, b2, x, drop=d2, save_y2d=True),
        "residual_wo_train": lambda: K.gemm_i8_bias_residual(
            *cq, woq, wos, bo, x, drop=dh, save_y2d=True),
        # the residual launches' library yardstick: the int8 products alone
        # (the column-major weights are cuBLASLt's int8 layout)
        "int_mm_residuals": lambda: [torch._int_mm(gq[0], w2q),
                                     torch._int_mm(cq[0], woq)],
        # the dgrads' library yardstick: the weight as w.t() (a column-
        # major view) or as a row-major copy made outside the timed call
        "int_mm_dgrads_view": lambda: [torch._int_mm(g[0], w.t())
                                       for g, w in pairs],
        "int_mm_dgrads_contiguous": lambda: [
            torch._int_mm(g[0], wt) for (g, _), wt in zip(pairs, contig)],
    }
    return {name: both_ms(fn, iters) for name, fn in calls.items()}


def encoder_times(dev, gen, iters: int) -> dict:
    """The serving encoder forward, 12 BERT-base layers at 64 x 256, with
    its GEMM weights in bf16 and quantized to int8 (as ``Predictor``
    prepares them); [back to back, device] ms."""
    from nbest_asr_tpu_torch.models.encoder import (EncoderConfig,
                                                    encoder_forward,
                                                    init_encoder_params)
    from nbest_asr_tpu_torch.ops.quant import (LAYER_GEMM_KERNELS,
                                               quantize_encoder_params)

    cfg = EncoderConfig.bert_base(compute_dtype="bfloat16",
                                  use_fused_attn=True, use_fused_ffn=True,
                                  use_fused_attn_eval=True)
    enc = init_encoder_params(torch.Generator(device=dev).manual_seed(0),
                              cfg)
    bf = dict(enc, layers={k: v.to(torch.bfloat16)
                           if k in LAYER_GEMM_KERNELS else v
                           for k, v in enc["layers"].items()})
    q8 = quantize_encoder_params({"encoder": enc})["encoder"]
    ids = torch.randint(1, cfg.vocab_size, (64, 256), generator=gen).to(dev)
    mask = torch.ones(64, 256, device=dev)
    segs = torch.zeros_like(ids)
    return {name: both_ms(lambda: encoder_forward(w, ids, mask, segs, cfg),
                          iters)
            for name, w in (("bf16", bf), ("int8", q8))}


def embed_times(dev, gen, iters: int) -> dict:
    """The plain embedding (word, position and type rows, LayerNorm) of
    BERT-base at a training micro of 128 x 64 (f32 tables, type ids 0 and
    1), forward and backward; around it, the 12-layer encoder's training
    forward and backward (both megakernels, bf16, dropout 0.1) at the same
    micro and its serving forward at 64 x 64; [back to back, device] ms."""
    from nbest_asr_tpu_torch.models.encoder import (EncoderConfig, _embed,
                                                    encoder_forward,
                                                    init_encoder_params)

    cfg = EncoderConfig.bert_base(compute_dtype="bfloat16",
                                  use_fused_attn=True, use_fused_ffn=True,
                                  use_fused_attn_eval=True,
                                  hidden_dropout=0.1, attn_dropout=0.1)
    enc = init_encoder_params(torch.Generator(device=dev).manual_seed(0),
                              cfg)
    for group in enc.values():
        for t in group.values():
            t.requires_grad_()
    ids = torch.randint(1, cfg.vocab_size, (128, 64), generator=gen).to(dev)
    types = torch.randint(0, 2, (128, 64), generator=gen).to(dev)
    mask = torch.ones(128, 64, device=dev)

    def embed_fwd_bwd():
        _embed(enc, ids, types, cfg, seed=1).float().sum().backward()

    def train_fwd_bwd():
        encoder_forward(enc, ids, mask, types, cfg, deterministic=False,
                        seed=1).float().sum().backward()

    def serve():
        with torch.no_grad():
            encoder_forward(enc, ids[:64], mask[:64], types[:64], cfg)

    # ~400 launches a training step: 10 calls enqueue within the sleep
    return {"embed_fwd_bwd": both_ms(embed_fwd_bwd, iters),
            "encoder_train_fwd_bwd": both_ms(train_fwd_bwd, 10),
            "encoder_serve_fwd_64": both_ms(serve, 10)}


def rows_times(K, dev, gen, iters: int) -> dict:
    """Route C's bias-GELU kernels on a training layer's (8192, 3072) bf16
    operands, beside ``F.gelu(x + b)`` and autograd's GELU backward (over a
    retained forward); [back to back, device] ms."""
    F = torch.nn.functional
    h = (torch.randn(8192, 4 * H, generator=gen) * 2).to(dev, torch.bfloat16)
    dh = torch.randn(8192, 4 * H, generator=gen).to(dev, torch.bfloat16)
    b1 = torch.randn(4 * H, generator=gen).to(dev)
    hl = h.detach().requires_grad_(True)
    g_lib = F.gelu(hl + b1.to(torch.bfloat16))
    calls = {
        "bias_gelu": lambda: K.bias_gelu(h, b1),
        "f_gelu": lambda: F.gelu(h + b1.to(torch.bfloat16)),
        "bias_gelu_bwd": lambda: K.bias_gelu_bwd(h, b1, dh),
        "gelu_backward": lambda: torch.autograd.grad(g_lib, (hl,), dh,
                                                     retain_graph=True),
    }
    # embed_lookup at one micro (8192 tokens, seq 256, f32 tables): BERT's
    # vocab and two type rows; XLM-R's vocab, one type row, type ids 0 and
    # 1 (the RoBERTa --add_segment_ids rows) and some ids in the padding
    for name, vocab, n_types, off in (("embed_lookup", 30522, 2, 0),
                                      ("embed_lookup_xlmr", 250002, 1, 2)):
        word = (torch.randn(vocab, H, generator=gen) * 0.05).to(dev)
        pos = (torch.randn(514, H, generator=gen) * 0.05).to(dev)
        type_ = (torch.randn(n_types, H, generator=gen) * 0.05).to(dev)
        ids = torch.randint(0, vocab, (8192,), generator=gen)
        ids[::97] = vocab
        tids = torch.randint(0, 2, (8192,), generator=gen)
        args = (word, pos[off:off + 256], type_, torch.ones(H, device=dev),
                torch.zeros(H, device=dev), ids.to(dev, torch.int32),
                tids.to(dev, torch.int32), 256, 1e-5)
        calls[name] = (lambda a: lambda: K.embed_lookup(*a))(args)
    return {name: both_ms(fn, iters) for name, fn in calls.items()}


# training micro rows per bucket under the 8192-token budget
TRAIN_MICRO = {64: 128, 96: 80, 160: 48, 256: 32}
# d = 64 past 256 keys: one micro of the token budget at BERT's 512
# positions, and lengths past the forward's first 256-key score window
LONG_MICRO = {512: 16, 300: 24, 384: 21}
# d = 192 past 256 keys (the CLI's from-scratch default on packed 512-token
# rows, long buckets, long N-best rows): LONG_MICRO's 512 and 300 micros,
# padded (rows of 3 s / 4 to s real tokens) and at 512 packed (three
# segments a row), and 4 x 300 -> (b, s, mask kind, key)
LONG_D192 = ((LONG_MICRO[512], 512, "padded", "16x512"),
             (LONG_MICRO[512], 512, "packed", "16x512 packed"),
             (LONG_MICRO[300], 300, "padded", "24x300"),
             (4, 300, "padded", "4x300"))


def long_mask(b: int, s: int, kind: str, gen, dev):
    """(b, s) segment ids: padded rows of 3 s / 4 to s real tokens, or
    packed rows of three segments cut at random points."""
    if kind == "padded":
        lengths = torch.randint(3 * s // 4, s + 1, (b, 1), generator=gen)
        return (torch.arange(s)[None] < lengths).float().to(dev)
    cuts = torch.sort(torch.randint(1, s, (b, 2), generator=gen)).values
    pos = torch.arange(s)[None]
    return (1.0 + (pos >= cuts[:, :1]).float()
            + (pos >= cuts[:, 1:]).float()).to(dev)


def sdpa_times(qkv, dctx, mask, nh: int, iters: int) -> dict:
    """SDPA's forward and forward + backward (its backward alone is their
    difference) on the q, k, v of a QKV buffer, the gradient dctx, the
    boolean segment mask and prob dropout 0.1: {"fwd", "fwd_bwd"}, each
    [back to back, device] ms."""
    F = torch.nn.functional
    n, h = dctx.shape
    b, d = mask.shape[0], h // nh
    s = n // b
    qt, kt, vt = qkv.view(b, s, 3, nh, d).permute(2, 0, 3, 1, 4)
    same = mask[:, None, :, None] == mask[:, None, None, :]
    go = dctx.view(b, s, nh, d).transpose(1, 2)

    def fwd_bwd():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=same, dropout_p=0.1).backward(go)

    return {"fwd": both_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=same, dropout_p=0.1), iters),
            "fwd_bwd": both_ms(fwd_bwd, iters)}


def train_bwd_times(K, dev, gen, drop, iters: int) -> dict:
    """The attention backward per training layer at each bucket's micro
    (a random two-segment mask, dropout 0.1): ``seg_attention_bwd`` on the
    QKV buffer, on route A's (b, s, heads, d) views (``sb_attention_bwd``,
    at 160 and 256) and beside it SDPA's forward and forward + backward on
    the same operands (its backward alone is their difference); the same
    past 256 keys at d = 64 (16 x 512, 24 x 300, 21 x 384, a padded mask:
    rows of 3 s / 4 to s real tokens), keyed ``train_bwd_long_ms`` (and
    ``sdpa_fwd_ms`` / ``sdpa_fwd_bwd_ms`` by seq); the d = 128 forward and
    backward at 8192 rows (6 heads) with SDPA's beside them
    (``d128_sdpa_ms``); ``layer_norm_rows`` x2 with statistics at 8192 x
    768 beside ``F.layer_norm`` x2.  Each as [back to back, device]
    ms."""
    F = torch.nn.functional
    out = {"train_bwd_bucket_ms": {}, "route_a_bwd_ms": {},
           "train_bwd_long_ms": {}, "sdpa_fwd_ms": {}, "sdpa_fwd_bwd_ms": {}}
    for s, b in list(TRAIN_MICRO.items()) + list(LONG_MICRO.items()):
        qkv = (torch.randn(b * s, 3 * H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        dctx = (torch.randn(b * s, H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        if s in LONG_MICRO:
            mask = long_mask(b, s, "padded", gen, dev)
        else:
            mask = (torch.rand(b, s, generator=gen) > 0.2).float().to(dev)
            mask[:, 0] = 1.0
        _, st = K.seg_attention(qkv, mask, NH, drop=drop, stats=True)
        key = "train_bwd_long_ms" if s in LONG_MICRO else "train_bwd_bucket_ms"
        out[key][s] = both_ms(
            lambda: K.seg_attention_bwd(qkv, dctx, mask, st, NH, drop=drop),
            iters)
        d = H // NH
        q, k, v = qkv.view(b, s, 3, NH, d).unbind(2)
        do = dctx.view(b, s, NH, d)
        if 160 <= s <= 256 and hasattr(K, "sb_attention_bwd"):
            out["route_a_bwd_ms"][s] = both_ms(
                lambda: K.sb_attention_bwd(q, k, v, do, mask, st, d ** -0.5,
                                           drop), iters)
        sd = sdpa_times(qkv, dctx, mask, NH, iters)
        out["sdpa_fwd_ms"][s], out["sdpa_fwd_bwd_ms"][s] = (sd["fwd"],
                                                           sd["fwd_bwd"])
    # d = 128 (the mma.sync pair): 8192 rows, 6 heads
    b, s, nh = 32, 256, H // 128
    qkv = (torch.randn(b * s, 3 * H, generator=gen) * 0.5).to(
        dev, torch.bfloat16)
    dctx = (torch.randn(b * s, H, generator=gen) * 0.5).to(dev,
                                                           torch.bfloat16)
    mask = (torch.rand(b, s, generator=gen) > 0.2).float().to(dev)
    _, st = K.seg_attention(qkv, mask, nh, drop=drop, stats=True)
    out["d128_fwd_ms"] = both_ms(
        lambda: K.seg_attention(qkv, mask, nh, drop=drop, stats=True), iters)
    out["d128_bwd_ms"] = both_ms(
        lambda: K.seg_attention_bwd(qkv, dctx, mask, st, nh, drop=drop),
        iters)
    out["d128_sdpa_ms"] = sdpa_times(qkv, dctx, mask, nh, iters)
    # layer_norm x2 with statistics, as a training layer runs it
    x = (torch.randn(8192, H, generator=gen) * 2).to(dev)
    ls = (1 + 0.1 * torch.randn(H, generator=gen)).to(dev)
    lb = (0.1 * torch.randn(H, generator=gen)).to(dev)
    out["layer_norm_train_ms"] = both_ms(
        lambda: [K.layer_norm_rows(x, ls, lb, 1e-12, stats=True)
                 for _ in range(2)], iters)
    out["f_layer_norm_ms"] = both_ms(
        lambda: [F.layer_norm(x, (H,), ls, lb, 1e-12) for _ in range(2)],
        iters)
    return out


def head_dim_times(K, dev, gen, iters: int) -> dict:
    """The single-block pair at the quality tools' head dim (8 heads of
    96) and at the CLI's from-scratch d = 192 (4 heads), each at every
    bucket's training micro: ``sb_attention`` with prob dropout 0.1
    and row statistics, ``sb_attention_bwd``, SDPA's forward and its
    backward alone (autograd.grad over a retained forward) on the same q,
    k, v views of one QKV buffer, padded mask and dropout rate; [back to
    back, device] ms, keyed "d96_ms" / "d192_ms" and then by seq; the d =
    192 pair past 256 keys (``LONG_D192``) keyed "16x512", "16x512
    packed", "24x300", "4x300"."""
    from nbest_asr_tpu_torch.ops.philox import site

    F = torch.nn.functional
    out = {"d96_ms": {}, "d192_ms": {}}
    cases = ([(d, H // d, b, s, None, s) for d in (96, 192)
              for s, b in TRAIN_MICRO.items()]
             + [(192, H // 192, b, s, kind, key)
                for b, s, kind, key in LONG_D192])
    for d, nh, b, s, kind, key in cases:
        q, k, v = (torch.randn(b * s, 3 * H, generator=gen) * 0.5).to(
            dev, torch.bfloat16).view(b, s, 3, nh, d).unbind(2)
        do = (torch.randn(b, s, nh, d, generator=gen) * 0.1).to(
            dev, torch.bfloat16)
        if kind is None:
            mask = (torch.rand(b, s, generator=gen) > 0.2).float().to(dev)
            mask[:, 0] = 1.0
        else:
            mask = long_mask(b, s, kind, gen, dev)
        drop, sc = site(1, 0.1, 3), 1.0 / d ** 0.5
        _, st = K.sb_attention(q, k, v, mask, sc, drop, True)
        same = mask[:, None, :, None] == mask[:, None, None, :]
        leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v)]
        sdpa_o = F.scaled_dot_product_attention(*leaves, attn_mask=same,
                                                dropout_p=0.1)
        go = do.transpose(1, 2)
        calls = {
            "fwd": lambda: K.sb_attention(q, k, v, mask, sc, drop, True),
            "bwd": lambda: K.sb_attention_bwd(q, k, v, do, mask, st, sc,
                                              drop),
            "sdpa_fwd": lambda: F.scaled_dot_product_attention(
                *leaves, attn_mask=same, dropout_p=0.1),
            "sdpa_bwd": lambda: torch.autograd.grad(sdpa_o, leaves, go,
                                                    retain_graph=True)}
        out[f"d{d}_ms"][key] = {name: both_ms(fn, iters)
                                for name, fn in calls.items()}
        del sdpa_o, leaves
    return out


def flash_times(K, dev, gen, iters: int, d: int = H // NH,
                b: int = 32) -> dict:
    """The tiled flash kernels at b x 1024, hidden 768 in heads of d (route
    B's layer: 32 x 1024, 12 heads of 64; the quality tools' encoder: 8
    heads of 96), q, k, v views of one QKV buffer, a padded mask, prob
    dropout 0.1: the forward, the backward pair, both without dropout,
    SDPA's forward and its backward alone on the same operands; [back to
    back, device] ms."""
    from nbest_asr_tpu_torch.ops.philox import site

    F = torch.nn.functional
    s, nh = 1024, H // d
    q, k, v = (torch.randn(b * s, 3 * H, generator=gen) * 0.5).to(
        dev, torch.bfloat16).view(b, s, 3, nh, d).unbind(2)
    do = (torch.randn(b, s, nh, d, generator=gen) * 0.1).to(
        dev, torch.bfloat16)
    mask = (torch.rand(b, s, generator=gen) > 0.2).float().to(dev)
    mask[:, 0] = 1.0
    drop, sc = site(1, 0.1, 3), 1.0 / d ** 0.5
    o, lse = K.flash_fwd(q, k, v, mask, sc, drop)
    _, di = K.flash_bwd_dq(q, k, v, mask, o, lse, do, sc, drop)
    o0, lse0 = K.flash_fwd(q, k, v, mask, sc)
    _, di0 = K.flash_bwd_dq(q, k, v, mask, o0, lse0, do, sc)
    same = mask[:, None, :, None] == mask[:, None, None, :]
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    sdpa_o = F.scaled_dot_product_attention(*leaves, attn_mask=same,
                                            dropout_p=0.1)
    go = do.transpose(1, 2)
    calls = {
        "fwd": lambda: K.flash_fwd(q, k, v, mask, sc, drop),
        "bwd_dq": lambda: K.flash_bwd_dq(q, k, v, mask, o, lse, do, sc,
                                         drop),
        "bwd_dkv": lambda: K.flash_bwd_dkv(q, k, v, mask, lse, di, do, sc,
                                           drop),
        "fwd_no_dropout": lambda: K.flash_fwd(q, k, v, mask, sc),
        "bwd_dq_no_dropout": lambda: K.flash_bwd_dq(q, k, v, mask, o0, lse0,
                                                    do, sc),
        "bwd_dkv_no_dropout": lambda: K.flash_bwd_dkv(q, k, v, mask, lse0,
                                                      di0, do, sc),
        "sdpa_fwd": lambda: F.scaled_dot_product_attention(
            *leaves, attn_mask=same, dropout_p=0.1),
        "sdpa_bwd": lambda: torch.autograd.grad(sdpa_o, leaves, go,
                                                retain_graph=True)}
    return {name: both_ms(fn, iters) for name, fn in calls.items()}


# the chunked family's shapes (b, s, heads, d): smoke phase 19's (b), BERT-base
# width in 2 heads of 384 at 32 x 256 (single-block), and (c), the CLI's
# --n_head 64 at hidden 768 (64 heads of 12), at 32 x 256 (single-block)
# and 32 x 1024 (tiled)
CHUNKED_SHAPES = ((32, 256, 2, 384), (32, 256, 64, 12), (32, 1024, 64, 12))


def chunked_times(K, dev, gen, iters: int) -> dict:
    """The chunked family at ``CHUNKED_SHAPES``: q, k, v views of one QKV
    buffer, a padded mask, prob dropout 0.1; at s <= 512 the single-block
    pair (``sb_attention`` with row statistics: ``chunked_fwd``, and
    ``sb_attention_bwd``: ``chunked_bwd_dq`` and ``chunked_bwd_dkv``),
    past it the tiled trio (``flash_fwd``, ``flash_bwd_dq``,
    ``flash_bwd_dkv``), and SDPA's forward on the same operands, mask and
    dropout rate; [back to back, device] ms, keyed "b x s x heads x d"."""
    from nbest_asr_tpu_torch.ops.philox import site

    F = torch.nn.functional
    out = {}
    for b, s, nh, d in CHUNKED_SHAPES:
        q, k, v = (torch.randn(b * s, 3 * H, generator=gen) * 0.5).to(
            dev, torch.bfloat16).view(b, s, 3, nh, d).unbind(2)
        do = (torch.randn(b, s, nh, d, generator=gen) * 0.1).to(
            dev, torch.bfloat16)
        lengths = torch.randint(3 * s // 4, s + 1, (b, 1), generator=gen)
        mask = (torch.arange(s)[None] < lengths).float().to(dev)
        drop, sc = site(1, 0.1, 3), 1.0 / d ** 0.5
        if s <= K.MAX_SEQ:
            _, st = K.sb_attention(q, k, v, mask, sc, drop, True)
            calls = {
                "fwd": lambda: K.sb_attention(q, k, v, mask, sc, drop, True),
                "bwd": lambda: K.sb_attention_bwd(q, k, v, do, mask, st, sc,
                                                  drop)}
        else:
            o, lse = K.flash_fwd(q, k, v, mask, sc, drop)
            _, di = K.flash_bwd_dq(q, k, v, mask, o, lse, do, sc, drop)
            calls = {
                "fwd": lambda: K.flash_fwd(q, k, v, mask, sc, drop),
                "bwd_dq": lambda: K.flash_bwd_dq(q, k, v, mask, o, lse, do,
                                                 sc, drop),
                "bwd_dkv": lambda: K.flash_bwd_dkv(q, k, v, mask, lse, di, do,
                                                   sc, drop)}
        same = mask[:, None, :, None] == mask[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        calls["sdpa_fwd"] = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=same, dropout_p=0.1)
        out[f"{b}x{s}x{nh}x{d}"] = {name: both_ms(fn, iters)
                                    for name, fn in calls.items()}
        del q, k, v, do, calls, same, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups to time, of "
                    f"{', '.join(GROUPS)} (default: all)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        ap.error(f"--only takes groups of {GROUPS}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script times the "
                           "port's kernels on an NVIDIA GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    from nbest_asr_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    out = {"root": args.root}
    for b, s in ((64, 64), (64, 96), (64, 160), (64, 256)):
        if "attention" not in only:
            break
        qkv = (torch.randn(b * s, 3 * H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        mask = (torch.rand(b, s, generator=gen) > 0.2).float().to(dev)
        out.setdefault("serving_ms", {})[s] = both_ms(
            lambda: K.seg_attention(qkv, mask, NH), args.iters)
    if "attention" in only and hasattr(K, "seg_attention_bwd"):
        from nbest_asr_tpu_torch.ops.philox import site

        b, s = 32, 256
        qkv = (torch.randn(b * s, 3 * H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        dctx = (torch.randn(b * s, H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        mask = (torch.rand(b, s, generator=gen) > 0.2).float().to(dev)
        drop = site(1, 0.1, 3)
        _, st = K.seg_attention(qkv, mask, NH, drop=drop, stats=True)
        out["train_fwd_ms"] = both_ms(
            lambda: K.seg_attention(qkv, mask, NH, drop=drop, stats=True),
            args.iters)
        out["train_bwd_ms"] = both_ms(
            lambda: K.seg_attention_bwd(qkv, dctx, mask, st, NH, drop=drop),
            args.iters)
        # the same without dropout: what the keep bits and drops cost
        _, st0 = K.seg_attention(qkv, mask, NH, stats=True)
        out["train_bwd_no_dropout_ms"] = both_ms(
            lambda: K.seg_attention_bwd(qkv, dctx, mask, st0, NH),
            args.iters)
        # seq 512 (two score windows on the wgmma kernel), 8192 rows
        b, s = 16, 512
        q5 = (torch.randn(b * s, 3 * H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        m5 = (torch.rand(b, s, generator=gen) > 0.2).float().to(dev)
        out["train_fwd_512_ms"] = both_ms(
            lambda: K.seg_attention(q5, m5, NH, drop=drop, stats=True),
            args.iters)
        out.update(train_bwd_times(K, dev, gen, drop, args.iters))
        if hasattr(K, "sb_attention_bwd"):
            out.update(head_dim_times(K, dev, gen, args.iters))
    if "int8" in only and hasattr(K, "gemm_i8_bias_act"):
        from nbest_asr_tpu_torch.ops.quant import (kernel_layout,
                                                   quantize_weight)

        def rows(k):
            return K.quantize_rows((torch.randn(64 * 256, k, generator=gen)
                                    * 0.5).to(dev, torch.bfloat16))

        def weight(k, n):
            q, sc = quantize_weight((torch.randn(k, n, generator=gen)
                                     * 0.02).to(dev))
            return kernel_layout(q), sc.reshape(-1), torch.zeros(n,
                                                                 device=dev)

        x, g = rows(H), rows(4 * H)
        r = torch.randn(64 * 256, H, generator=gen).to(dev, torch.bfloat16)
        wqkv, w1, wo, w2 = (weight(H, 3 * H), weight(H, 4 * H),
                            weight(H, H), weight(4 * H, H))
        xb = (torch.randn(64 * 256, H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        gb = (torch.randn(64 * 256, 4 * H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        out["serving_i8_ms"] = {
            "quantize_rows": both_ms(lambda: K.quantize_rows(xb), args.iters),
            "quantize_rows_3072": both_ms(lambda: K.quantize_rows(gb),
                                          args.iters),
            # the four of a layer: x, ctx, x2, the GELU output
            "quantize_rows_x4": both_ms(
                lambda: [K.quantize_rows(t) for t in (xb, xb, xb, gb)],
                args.iters),
            "act_qkv": both_ms(lambda: K.gemm_i8_bias_act(*x, *wqkv),
                               args.iters),
            "act_w1_gelu": both_ms(
                lambda: K.gemm_i8_bias_act(*x, *w1, "gelu"), args.iters),
            "residual_wo": both_ms(
                lambda: K.gemm_i8_bias_residual(*x, *wo, r), args.iters),
            "residual_w2": both_ms(
                lambda: K.gemm_i8_bias_residual(*g, *w2, r), args.iters)}
        if hasattr(K, "gemm_i8_dgrad"):
            out["train_i8_ms"] = train_i8_times(K, dev, gen, args.iters)
            # ~170 launches a forward: 10 calls enqueue within the sleep
            out["encoder_fwd_ms"] = encoder_times(dev, gen, 10)
    if "flash" in only and hasattr(K, "flash_fwd"):
        out["flash_ms"] = flash_times(K, dev, gen, args.iters)
        # the quality tools' encoder: 8 heads of 96, at phase 18's 32 x
        # 1024 and at its tiled leg's 48 x 1024
        out["flash_d96_ms"] = {f"{b}x1024": flash_times(K, dev, gen,
                                                        args.iters, 96, b)
                               for b in (32, 48)}
    if "gemm" in only and hasattr(K, "gemm_dgrad"):
        out["gemm_ms"] = gemm_times(K, dev, gen, args.iters)
    if "rows" in only and hasattr(K, "bias_gelu_bwd"):
        out["rows_ms"] = rows_times(K, dev, gen, args.iters)
    if "embed" in only:
        out["embed_ms"] = embed_times(dev, gen, args.iters)
    if "chunked" in only and hasattr(K, "attn_chunked_launches"):
        out["chunked_ms"] = chunked_times(K, dev, gen, args.iters)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
