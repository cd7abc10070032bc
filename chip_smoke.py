#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``nbest_asr_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the repository root.

Phases, each fatal on failure:

1. Device: refuse to run without CUDA; print the card, its power limit,
   the torch and CUDA versions; build the hand-written kernels from
   ``nbest_asr_tpu_torch/csrc`` (nvcc, first use) and print the seconds.
2. Kernels against their plain PyTorch versions, on the card, at
   BERT-base widths in bf16: batch 64 x seq {64, 96, 160, 256} plus a
   ragged 3 x 20 case, with padded 1/0 and packed multi-segment masks;
   each kernel and the four block functions (bf16 and int8).  The int8
   kernels must equal their plain versions bit for bit (the GELU
   epilogue within one bf16 ulp).  Prints per-bucket times.
3. The slice: ``Predictor(device="cuda", quantize="none")`` on a
   12-layer BERT-base encoder (random weights from
   ``torch.Generator().manual_seed(0)``) over a synthetic DSTC2-like
   label hierarchy serves four requests of 256 utterances, one per length
   bucket, through ``predict``, ``predict_async`` and ``scores``.  The
   kernels' launch counters must rise by exactly layers x batches x
   launches-per-layer.  The same weights through the plain path (the
   three kernel flags off) must agree on >= 98% of utterances over the
   label decisions an f32 plain run resolves beyond bf16 noise (raw
   label agreement is printed too), and the kernel path's scores are
   held to that f32 run.
3b. The int8 slice: ``Predictor(device="cuda", quantize="int8")`` on the
   same weights serves the same requests.  The int8 kernels' counters
   rise by exactly layers x batches x launches-per-layer while the bf16
   GEMM counters stay at 0; agreement with the int8 plain path on the
   decisions the f32 run resolves must be >= 98%, and the int8 scores
   within 5e-2 of the f32 run (``nbest_asr_tpu/ops/quant.py:31``).
4. Times: ms per batch of 64 for the kernel and the plain forward per
   bucket (CUDA events, after warm-up) and ``predict`` utt/s, bf16 and
   int8 side by side (int8 and bf16 ``predict`` alternate, ABBA).

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BUCKETS = (64, 96, 160, 256)
BATCH = 64
H, NH, INTER, LAYERS, VOCAB = 768, 12, 3072, 12, 30522
REQUEST = 256                       # utterances per request
KERNEL_SOURCES = {
    "gemm_bias_act": "nbest_asr_tpu_torch/csrc/gemm.cu",
    "gemm_bias_residual": "nbest_asr_tpu_torch/csrc/gemm.cu",
    "layer_norm": "nbest_asr_tpu_torch/csrc/layer_norm.cu",
    "seg_attention": "nbest_asr_tpu_torch/csrc/seg_attention.cu",
    "quantize_rows": "nbest_asr_tpu_torch/csrc/quant_rows.cu",
    "gemm_i8_bias_act": "nbest_asr_tpu_torch/csrc/gemm_i8.cu",
    "gemm_i8_bias_residual": "nbest_asr_tpu_torch/csrc/gemm_i8.cu",
}
FAB = "nbest_asr_tpu/ops/fused_attention.py:152"
FFN = "nbest_asr_tpu/ops/fused_ffn.py:166"
I8A = "nbest_asr_tpu/ops/int8_serving.py:157"
I8F = "nbest_asr_tpu/ops/int8_serving.py:90"
KERNEL_REPLACES = {
    "gemm_bias_act": f"{FAB} (QKV GEMM) + {FFN} (W1 GEMM + GELU)",
    "gemm_bias_residual": f"{FAB} (out-proj) + {FFN} (W2 GEMM), "
                          "+ residual",
    "layer_norm": f"{FAB} + {FFN} + {I8A} + {I8F} (LayerNorm tails)",
    "seg_attention": f"{FAB} (head loop, _head_probs :103) + {I8A} "
                     "(head loop :169-189)",
    "quantize_rows": f"{I8A} + {I8F} (_quant_rows :57)",
    "gemm_i8_bias_act": f"{I8A} (QKV _dense_i8) + {I8F} (W1 _dense_i8 + "
                        "GELU)",
    "gemm_i8_bias_residual": f"{I8A} (out-proj _dense_i8) + {I8F} (W2 "
                             "_dense_i8), + residual",
}
# launches of each kernel per encoder layer on the routed bf16 and int8
# paths (ops/fused_*.py, ops/int8_serving.py); every other kernel 0
PER_LAYER = {"gemm_bias_act": 2, "gemm_bias_residual": 2, "layer_norm": 2,
             "seg_attention": 1}
PER_LAYER_I8 = {"quantize_rows": 4, "gemm_i8_bias_act": 2,
                "gemm_i8_bias_residual": 2, "layer_norm": 2,
                "seg_attention": 1}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
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


class Checker:
    """Holds a kernel's output to its plain version's; any breach is
    fatal.  Tolerances (bf16 outputs, both sides f32-accumulated with the
    same rounding points, so they differ only where a different
    summation order flips a bf16 rounding):
      - GEMM and attention outputs: max |d| <= 2**-6 * max|want| (two
        bf16 ulps at the tensor's largest magnitude), mean |d| <= 1e-3;
      - LayerNorm outputs: max |d| <= 5e-2, mean |d| <= 5e-3 (|y| < 8
        here, so 5e-2 is under two bf16 ulps)."""

    def __init__(self):
        self.max_err = {}

    def __call__(self, name, kernel, got, want, ln: bool):
        d = (got.float() - want.float()).abs()
        mx, mean = d.max().item(), d.mean().item()
        lim_max = 5e-2 if ln else 2.0 ** -6 * want.float().abs().max().item()
        lim_mean = 5e-3 if ln else 1e-3
        ok = (mx <= lim_max and mean <= lim_mean
              and bool(torch.isfinite(got.float()).all()))
        log(f"  {'ok ' if ok else 'BAD'} {name}: max {mx:.3e} (<= "
            f"{lim_max:.3e}) mean {mean:.3e} (<= {lim_mean:.0e})")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 "version")
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), mx)

    def exact(self, name, kernel, got, want, bf16_ulps: int = 0):
        """Bit-equality, or at most ``bf16_ulps`` bf16 ulps of ``want``
        per element (the GELU epilogue: erff against torch.erf)."""
        d = (got.float() - want.float()).abs()
        ulp = torch.exp2(torch.floor(torch.log2(
            want.float().abs().clamp_min(2.0 ** -126))) - 7)
        ok = bool((d <= bf16_ulps * ulp).all()) and got.dtype == want.dtype
        mx = d.max().item()
        n_diff = int((d > 0).sum())
        log(f"  {'ok ' if ok else 'BAD'} {name}: {n_diff} of {d.numel()} "
            f"differ, max {mx:.3e} (<= {bf16_ulps} bf16 ulp)")
        if not ok:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 "version")
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), mx)


def int8_weights(p):
    """The bf16 weights quantized as the int8 Predictor holds them."""
    from nbest_asr_tpu_torch.ops.quant import kernel_layout, quantize_weight

    out = {}
    for name in ("wqkv", "wo", "w1", "w2"):
        q, scale = quantize_weight(p[name].float())
        out[name] = (kernel_layout(q), scale.reshape(-1))
    return out


def check_int8(K, p, q8, x, x2, pad, packed, check):
    """Each int8 kernel and both int8 blocks against their plain versions
    on the card; returns the kernels' intermediate outputs."""
    from nbest_asr_tpu_torch.ops.int8_serving import (
        int8_attention_block, int8_attention_block_reference,
        int8_ffn_block, int8_ffn_block_reference)

    def quant(name, a):
        q, sc = K.quantize_rows(a)
        torch.cuda.synchronize()
        rq, rs = K.quantize_rows_reference(a)
        check.exact(f"quantize_rows {name} q", "quantize_rows", q, rq)
        check.exact(f"quantize_rows {name} scale", "quantize_rows", sc, rs)
        return q, sc

    xq = quant("x", x2)
    qkv = K.gemm_i8_bias_act(*xq, *q8["wqkv"], p["bqkv"])
    torch.cuda.synchronize()
    check.exact("gemm_i8_bias_act qkv", "gemm_i8_bias_act", qkv,
                K.gemm_i8_bias_act_reference(*xq, *q8["wqkv"], p["bqkv"]))
    cq = quant("ctx", K.seg_attention(qkv, pad, NH))
    sres = K.gemm_i8_bias_residual(*cq, *q8["wo"], p["bo"], x2)
    torch.cuda.synchronize()
    check.exact("gemm_i8_bias_residual out-proj", "gemm_i8_bias_residual",
                sres, K.gemm_i8_bias_residual_reference(*cq, *q8["wo"],
                                                        p["bo"], x2))
    g = K.gemm_i8_bias_act(*xq, *q8["w1"], p["b1"], "gelu")
    torch.cuda.synchronize()
    check.exact("gemm_i8_bias_act w1+gelu", "gemm_i8_bias_act", g,
                K.gemm_i8_bias_act_reference(*xq, *q8["w1"], p["b1"],
                                             "gelu"), bf16_ulps=1)
    gq = quant("gelu", g)
    s2 = K.gemm_i8_bias_residual(*gq, *q8["w2"], p["b2"], x2)
    torch.cuda.synchronize()
    check.exact("gemm_i8_bias_residual w2", "gemm_i8_bias_residual", s2,
                K.gemm_i8_bias_residual_reference(*gq, *q8["w2"], p["b2"],
                                                  x2))
    attn_args = (x, *q8["wqkv"], p["bqkv"], *q8["wo"], p["bo"], p["ls"],
                 p["lb"])
    for mname, m in (("padded", pad), ("packed", packed)):
        got = int8_attention_block(*attn_args, m, n_heads=NH)
        torch.cuda.synchronize()
        check(f"int8_attention_block {mname}", "block", got,
              int8_attention_block_reference(*attn_args, m, n_heads=NH),
              True)
    ffn_args = (x, *q8["w1"], p["b1"], *q8["w2"], p["b2"], p["ls"], p["lb"])
    got = int8_ffn_block(*ffn_args)
    torch.cuda.synchronize()
    check("int8_ffn_block", "block", got, int8_ffn_block_reference(
        *ffn_args), True)
    return xq, cq, g, gq, attn_args, ffn_args


def masks(b, s, gen, dev):
    """(padded 1/0 mask, packed mask of segments 1..3 then pads)."""
    pad = (torch.rand(b, s, generator=gen) > 0.2).float()
    pad[:, 0] = 1.0
    packed = torch.zeros(b, s)
    for i in range(b):
        c = torch.sort(torch.randperm(s - 1, generator=gen)[:3] + 1).values
        packed[i, :c[0]], packed[i, c[0]:c[1]] = 1.0, 2.0
        packed[i, c[1]:c[2]] = 3.0
    return pad.to(dev), packed.to(dev)


def phase_kernels(dev, card: str):
    from nbest_asr_tpu_torch.ops import kernels as K
    from nbest_asr_tpu_torch.ops.fused_attention import (
        fused_attention_block, fused_attention_block_reference)
    from nbest_asr_tpu_torch.ops.fused_ffn import (fused_ffn_block,
                                                   fused_ffn_block_reference)
    from nbest_asr_tpu_torch.ops.int8_serving import (
        int8_attention_block, int8_attention_block_reference,
        int8_ffn_block, int8_ffn_block_reference)

    gen = torch.Generator().manual_seed(1)

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to(dev, dtype)

    p = {"wqkv": rn(H, 3 * H, std=0.02), "bqkv": rn(3 * H, std=0.02,
                                                     dtype=torch.float32),
         "wo": rn(H, H, std=0.02), "bo": rn(H, std=0.02,
                                            dtype=torch.float32),
         "w1": rn(H, INTER, std=0.02), "b1": rn(INTER, std=0.02,
                                                dtype=torch.float32),
         "w2": rn(INTER, H, std=0.02), "b2": rn(H, std=0.02,
                                               dtype=torch.float32),
         "ls": 1.0 + rn(H, std=0.1, dtype=torch.float32),
         "lb": rn(H, std=0.1, dtype=torch.float32)}
    q8 = int8_weights(p)
    check = Checker()
    times = {}
    for b, s in [(3, 20)] + [(BATCH, s) for s in BUCKETS]:
        log(f"[kernels] batch {b} x seq {s}")
        x = rn(b, s, H)
        x2 = x.reshape(b * s, H)
        pad, packed = masks(b, s, gen, dev)
        qkv = K.gemm_bias_act(x2, p["wqkv"], p["bqkv"])
        torch.cuda.synchronize()
        check("gemm_bias_act qkv", "gemm_bias_act", qkv,
              K.gemm_bias_act_reference(x2, p["wqkv"], p["bqkv"]), False)
        for mname, m in (("padded", pad), ("packed", packed)):
            ctx = K.seg_attention(qkv, m, NH)
            torch.cuda.synchronize()
            check(f"seg_attention {mname}", "seg_attention", ctx,
                  K.seg_attention_reference(qkv, m, NH), False)
        sres = K.gemm_bias_residual(ctx, p["wo"], p["bo"], x2)
        torch.cuda.synchronize()
        check("gemm_bias_residual out-proj", "gemm_bias_residual", sres,
              K.gemm_bias_residual_reference(ctx, p["wo"], p["bo"], x2),
              False)
        y = K.layer_norm_rows(sres, p["ls"], p["lb"], 1e-12)
        torch.cuda.synchronize()
        check("layer_norm", "layer_norm", y,
              K.layer_norm_reference(sres, p["ls"], p["lb"], 1e-12,
                                     torch.bfloat16), True)
        g = K.gemm_bias_act(x2, p["w1"], p["b1"], act="gelu")
        torch.cuda.synchronize()
        check("gemm_bias_act w1+gelu", "gemm_bias_act", g,
              K.gemm_bias_act_reference(x2, p["w1"], p["b1"], act="gelu"),
              False)
        s2 = K.gemm_bias_residual(g, p["w2"], p["b2"], x2)
        torch.cuda.synchronize()
        check("gemm_bias_residual w2", "gemm_bias_residual", s2,
              K.gemm_bias_residual_reference(g, p["w2"], p["b2"], x2),
              False)
        attn_args = (x, p["wqkv"], p["bqkv"], p["wo"], p["bo"], p["ls"],
                     p["lb"])
        for mname, m in (("padded", pad), ("packed", packed)):
            got = fused_attention_block(*attn_args, m, n_heads=NH)
            torch.cuda.synchronize()
            check(f"fused_attention_block {mname}", "block", got,
                  fused_attention_block_reference(*attn_args, m,
                                                  n_heads=NH), True)
        ffn_args = (x, p["w1"], p["b1"], p["w2"], p["b2"], p["ls"],
                    p["lb"])
        got = fused_ffn_block(*ffn_args)
        torch.cuda.synchronize()
        check("fused_ffn_block", "block", got,
              fused_ffn_block_reference(*ffn_args), True)
        xq, cq, g8, gq, i8_attn, i8_ffn = check_int8(K, p, q8, x, x2, pad,
                                                     packed, check)
        if b != BATCH:
            continue
        # per-layer time of each kernel's launches, kernel vs plain
        t = {
            "gemm_bias_act": (
                lambda: (K.gemm_bias_act(x2, p["wqkv"], p["bqkv"]),
                         K.gemm_bias_act(x2, p["w1"], p["b1"], "gelu")),
                lambda: (K.gemm_bias_act_reference(x2, p["wqkv"],
                                                   p["bqkv"]),
                         K.gemm_bias_act_reference(x2, p["w1"], p["b1"],
                                                   "gelu"))),
            "gemm_bias_residual": (
                lambda: (K.gemm_bias_residual(ctx, p["wo"], p["bo"], x2),
                         K.gemm_bias_residual(g, p["w2"], p["b2"], x2)),
                lambda: (K.gemm_bias_residual_reference(ctx, p["wo"],
                                                        p["bo"], x2),
                         K.gemm_bias_residual_reference(g, p["w2"],
                                                        p["b2"], x2))),
            "layer_norm": (
                lambda: [K.layer_norm_rows(sres, p["ls"], p["lb"], 1e-12)
                         for _ in range(2)],
                lambda: [K.layer_norm_reference(sres, p["ls"], p["lb"],
                                                1e-12, torch.bfloat16)
                         for _ in range(2)]),
            "seg_attention": (
                lambda: K.seg_attention(qkv, pad, NH),
                lambda: K.seg_attention_reference(qkv, pad, NH)),
            "attention_block": (
                lambda: fused_attention_block(*attn_args, pad, n_heads=NH),
                lambda: fused_attention_block_reference(*attn_args, pad,
                                                        n_heads=NH)),
            "ffn_block": (
                lambda: fused_ffn_block(*ffn_args),
                lambda: fused_ffn_block_reference(*ffn_args)),
            # int8: quantize x for both blocks, ctx and the GELU output
            "quantize_rows": (
                lambda: [K.quantize_rows(a) for a in (x2, ctx, x2, g8)],
                lambda: [K.quantize_rows_reference(a)
                         for a in (x2, ctx, x2, g8)]),
            "gemm_i8_bias_act": (
                lambda: (K.gemm_i8_bias_act(*xq, *q8["wqkv"], p["bqkv"]),
                         K.gemm_i8_bias_act(*xq, *q8["w1"], p["b1"],
                                            "gelu")),
                lambda: (K.gemm_i8_bias_act_reference(*xq, *q8["wqkv"],
                                                      p["bqkv"]),
                         K.gemm_i8_bias_act_reference(*xq, *q8["w1"],
                                                      p["b1"], "gelu"))),
            "gemm_i8_bias_residual": (
                lambda: (K.gemm_i8_bias_residual(*cq, *q8["wo"], p["bo"],
                                                 x2),
                         K.gemm_i8_bias_residual(*gq, *q8["w2"], p["b2"],
                                                 x2)),
                lambda: (K.gemm_i8_bias_residual_reference(
                    *cq, *q8["wo"], p["bo"], x2),
                         K.gemm_i8_bias_residual_reference(
                             *gq, *q8["w2"], p["b2"], x2))),
            "int8_attention_block": (
                lambda: int8_attention_block(*i8_attn, pad, n_heads=NH),
                lambda: int8_attention_block_reference(*i8_attn, pad,
                                                       n_heads=NH)),
            "int8_ffn_block": (
                lambda: int8_ffn_block(*i8_ffn),
                lambda: int8_ffn_block_reference(*i8_ffn)),
        }
        for name, (fk, fp) in t.items():
            times[(name, s)] = (cuda_ms(fk), cuda_ms(fp, iters=3))
        # cuBLAS bf16 products of the same shapes, for scale only (not a
        # port of anything): QKV + W1 and out-proj + W2
        cub = cuda_ms(lambda: (x2 @ p["wqkv"], x2 @ p["w1"],
                               ctx @ p["wo"], g @ p["w2"]))
        for name in t:
            k_ms, p_ms = times[(name, s)]
            log(f"  time {name:<18} b{b} s{s}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms [{card}]")
        log(f"  time cublas_bf16_4gemm  b{b} s{s}: {cub:.4f} ms "
            f"(torch.matmul bf16, same four products, for scale) [{card}]")
    return check.max_err, times


def dstc2_like_memory():
    """A synthetic label hierarchy shaped like DSTC2's: value-bearing
    inform/confirm/deny groups (with their NONE labels), request-slot and
    bare-act singletons, and a word vocabulary of ~900 words."""
    from nbest_asr_tpu.data.etl import build_memory

    values = {"food": ["chinese", "indian", "italian", "thai", "french",
                       "korean", "british", "european", "spanish"],
              "area": ["north", "south", "east", "west", "centre"],
              "pricerange": ["cheap", "moderate", "expensive"]}
    labels = []
    for act in ("inform", "confirm", "deny"):
        for slot, vals in values.items():
            labels += [f"{act}-{slot}-{v}" for v in vals]
    labels += [f"request-{s}" for s in ("phone", "addr", "postcode", "food",
                                        "area", "pricerange", "name")]
    labels += ["thankyou", "bye", "hello", "affirm", "negate", "repeat",
               "reqalts", "ack", "restart", "reqmore"]
    words = [w for vals in values.values() for w in vals]
    words += ("i want a restaurant in the part of town serving food what "
              "is phone number address post code price range thank you "
              "good bye yes no is there anything else please").split()
    words += [f"w{i}" for i in range(850)]
    return build_memory(words * 2, labels, ["inform", "request", "offer"])


def requests(memory, seed):
    """Four requests of REQUEST utterances; in request i the longest
    utterance packs to bucket BUCKETS[i], the others spread below it."""
    rng = np.random.RandomState(seed)
    words = [w for w in memory.word2idx if w.isalnum()]
    out = []
    lo = 8
    for bucket in BUCKETS:
        batch = []
        for j in range(REQUEST):
            # tokens = [CLS] + sys + [sep] + hyps with [sep] between + [sep]
            target = bucket - 4 if j == 0 else rng.randint(lo, bucket - 3)
            n_sys = rng.randint(1, max(2, target // 4))
            n_hyp = rng.randint(1, 6)
            budget = max(n_hyp, target - n_sys - 3 - (n_hyp - 1))
            cuts = np.sort(rng.choice(np.arange(1, budget), n_hyp - 1,
                                      replace=False)) if n_hyp > 1 else []
            sizes = np.diff(np.concatenate([[0], cuts, [budget]])).astype(int)
            hyps = [" ".join(rng.choice(words, size=max(int(k), 1)))
                    for k in sizes]
            batch.append(" ".join(["[CLS]", "[SYS]",
                                   *rng.choice(words, size=n_sys), "[USR]",
                                   " [SEP] ".join(hyps)]))
        out.append(batch)
        lo = bucket - 8
    return out


def head_outputs(predictor, req):
    """(top scores, group probs) of ``predictor``'s forward on ``req``,
    batch by batch as ``predict`` runs them, as numpy."""
    from nbest_asr_tpu_torch.models.model import model_forward

    pk = predictor._pack([u.split() for u in req])
    tops, probs = [], []
    with torch.inference_mode():
        for start in range(0, len(req), BATCH):
            ids = torch.from_numpy(pk.input_ids[start:start + BATCH])
            top, prob, _, _ = model_forward(
                predictor._fwd_params, predictor.cfg, predictor.hier,
                ids.to(predictor.device),
                torch.from_numpy(pk.attn_mask[start:start + BATCH]).to(
                    predictor.device),
                torch.zeros_like(ids).to(predictor.device))
            tops.append(top.float().cpu().numpy())
            probs.append(prob.float().cpu().numpy())
    return np.concatenate(tops), np.concatenate(probs)


def resolvable_disagreements(a, b, ref, arrays, tau: float):
    """Per utterance: do paths ``a`` and ``b`` make a different decision
    that the f32 reference ``ref`` resolves by more than ``tau``?

    The decode (train/decode.py) makes two kinds of decision: a top group
    fires when its score passes 0.5, and a firing multi-member group emits
    its arg-max member.  A decision is resolvable when the reference's
    margin -- |top - 0.5|, or the gap between the group's two largest
    probabilities -- exceeds ``tau``.  Each of ``a``, ``b``, ``ref`` is
    (top (n, n_top), probs (n, n_bottom))."""
    fire_a, fire_b = a[0] > 0.5, b[0] > 0.5
    res_top = np.abs(ref[0] - 0.5) > tau
    bad = ((fire_a != fire_b) & res_top).any(axis=1)
    member = arrays.membership > 0                      # (n_top, n_bottom)
    for g in np.nonzero(arrays.is_multi_top)[0]:
        cols = np.nonzero(member[g])[0]
        srt = np.sort(ref[1][:, cols], axis=1)
        res = (srt[:, -1] - srt[:, -2]) > tau
        win_a = cols[np.argmax(a[1][:, cols], axis=1)]
        win_b = cols[np.argmax(b[1][:, cols], axis=1)]
        bad |= fire_a[:, g] & fire_b[:, g] & res & (win_a != win_b)
    n_dec = res_top.size
    return bad, 1.0 - res_top.sum() / n_dec


def drive(predictor, reqs, per_layer):
    """The main path: every request through ``predict``,
    ``predict_async`` and ``scores``, with the launch counters set to 0
    just before and read just after.  Fails unless each kernel launched
    exactly layers x forwards x its launches per layer (0 if absent)."""
    from nbest_asr_tpu_torch.ops import _cuda

    predictor.predict(reqs[0][:BATCH])             # warm-up, not counted
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    labels, scores = [], []
    for req in reqs:
        labels.append(predictor.predict(req))
        if predictor.predict_async(req).result() != labels[-1]:
            raise AssertionError("predict_async disagrees with predict")
        scores.append(predictor.scores(req))
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)
    n_forwards = 3 * len(reqs) * (REQUEST // BATCH)
    want = {k: per_layer.get(k, 0) * LAYERS * n_forwards for k in counts}
    log(f"[slice] {predictor.quantize}: launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError("kernel launch counts differ from layers x "
                             "batches x launches per layer")
    return labels, scores, counts


def hold_to_plain(name, kp, pp, fp, reqs, k_labels, k_scores, arrays,
                  max_mean, max_abs=None):
    """Gate the kernel path ``kp`` against the plain path ``pp`` on the
    decisions the f32 run ``fp`` resolves by more than tau (twice the
    plain path's own largest deviation from f32), and its scores against
    the f32 run: mean |d| <= ``max_mean`` and, if given, max |d| <=
    ``max_abs``."""
    raw = bad_total = total = 0
    for i, req in enumerate(reqs):
        sc = k_scores[i]
        if sc.shape != (REQUEST, kp.memory.n_bottom) or \
                not np.isfinite(sc).all():
            raise AssertionError(f"scores: shape {sc.shape}, finite "
                                 f"{np.isfinite(sc).all()}")
        p_labels = pp.predict(req)
        p_scores = pp.scores(req)
        f_scores = fp.scores(req)
        ko, po, fo = (head_outputs(p, req) for p in (kp, pp, fp))
        tau = 2.0 * max(np.abs(po[0] - fo[0]).max(),
                        np.abs(po[1] - fo[1]).max())
        bad, unresolved = resolvable_disagreements(ko, po, fo, arrays, tau)
        a = sum(x == y for x, y in zip(k_labels[i], p_labels))
        raw += a
        bad_total += int(bad.sum())
        total += len(req)
        d = np.abs(sc - p_scores)
        dk, dp = np.abs(sc - f_scores), np.abs(p_scores - f_scores)
        log(f"[slice] {name} bucket {BUCKETS[i]}: raw label agreement "
            f"kernel vs plain {a}/{len(req)}; resolvable disagreements "
            f"{bad.sum()} (tau {tau:.3e}, {unresolved:.3f} of top decisions "
            f"unresolved); |scores kernel - plain| max {d.max():.3e} mean "
            f"{d.mean():.3e}; |scores - f32| kernel max {dk.max():.3e} "
            f"mean {dk.mean():.3e}, plain max {dp.max():.3e} mean "
            f"{dp.mean():.3e}")
        if dk.mean() > max_mean:
            raise AssertionError(f"{name}: kernel-path scores off f32 by "
                                 f"{dk.mean():.3e} on average")
        if max_abs is not None and dk.max() > max_abs:
            raise AssertionError(f"{name}: kernel-path scores off f32 by "
                                 f"{dk.max():.3e} > {max_abs}")
    rate = 1.0 - bad_total / total
    log(f"[slice] {name}: agreement kernel vs plain on resolvable "
        f"decisions: {total - bad_total}/{total} = {rate:.4f}; raw label "
        f"agreement {raw}/{total} = {raw / total:.4f}")
    if rate < 0.98:
        raise AssertionError(f"{name}: agreement {rate:.4f} < 0.98")


def phase_slice(dev):
    import dataclasses

    from nbest_asr_tpu.data.tokenizer import WordVocabTokenizer
    from nbest_asr_tpu_torch.models.encoder import EncoderConfig
    from nbest_asr_tpu_torch.models.model import (ModelConfig,
                                                  init_model_params)
    from nbest_asr_tpu_torch.serve import Predictor

    memory = dstc2_like_memory()
    tok = WordVocabTokenizer(memory)
    enc = EncoderConfig.bert_base(vocab_size=VOCAB,
                                  compute_dtype="bfloat16",
                                  use_fused_attn=True, use_fused_ffn=True,
                                  use_fused_attn_eval=True)
    cfg = ModelConfig(encoder=enc, n_top=memory.n_top,
                      n_bottom=memory.n_bottom)
    t0 = time.perf_counter()
    params = init_model_params(torch.Generator().manual_seed(0), cfg)
    log(f"[slice] BERT-base init {time.perf_counter() - t0:.1f} s; "
        f"n_top {memory.n_top}, n_bottom {memory.n_bottom}, "
        f"word vocab {tok.vocab_size}")
    plain_cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        enc, use_fused_attn=False, use_fused_ffn=False,
        use_fused_attn_eval=False))
    f32_cfg = dataclasses.replace(plain_cfg, encoder=dataclasses.replace(
        plain_cfg.encoder, compute_dtype="float32"))
    kw = dict(device=dev, batch_size=BATCH, max_len=BUCKETS[-1])
    kp = Predictor(params, cfg, memory, tok, quantize="none", **kw)
    pp = Predictor(params, plain_cfg, memory, tok, quantize="none", **kw)
    fp = Predictor(params, f32_cfg, memory, tok, quantize="none", **kw)
    reqs = requests(memory, seed=0)
    for bucket, req in zip(BUCKETS, reqs):
        got = kp._pack([u.split() for u in req]).max_len
        if got != bucket:
            raise AssertionError(f"request meant for bucket {bucket} packed "
                                 f"to {got}")
    arrays = memory.arrays()

    # ---- bf16: main path through the kernels, counted, then held ------- #
    # Raw label agreement between two bf16 paths is printed but not the
    # gate: with random weights every top score sits within a few tenths
    # of the 0.5 threshold, where the plain path's bf16 residual rounding
    # (the JAX XLA path's; the kernels keep the residual sum in f32) flips
    # labels (H100, seed-0 BERT-base: 80% raw agreement at score
    # differences < 9e-3).  The gate is agreement on the decisions an f32
    # run resolves by more than tau = twice the plain path's own largest
    # deviation from that f32 run; a wrong kernel flips resolvable
    # decisions.  bf16 activations through 12 layers move scores in
    # [0, 1] by about 1e-3 on average; a wrong kernel moves them by O(0.1).
    k_labels, k_scores, counts = drive(kp, reqs, PER_LAYER)
    hold_to_plain("bf16", kp, pp, fp, reqs, k_labels, k_scores, arrays,
                  max_mean=5e-3)
    del pp

    # ---- int8: the same weights and requests through the int8 chains --- #
    # The int8 plain path (the three kernel flags off) runs the plain
    # int8 dense of ops/quant.py; tau is twice ITS largest deviation from
    # the f32 run.  Scores must stay within 5e-2 of the f32 run, the bound
    # the JAX package states for int8 (nbest_asr_tpu/ops/quant.py:31).
    qp = Predictor(params, cfg, memory, tok, quantize="int8", **kw)
    qpp = Predictor(params, plain_cfg, memory, tok, quantize="int8", **kw)
    q_labels, q_scores, q_counts = drive(qp, reqs, PER_LAYER_I8)
    hold_to_plain("int8", qp, qpp, fp, reqs, q_labels, q_scores, arrays,
                  max_mean=5e-2, max_abs=5e-2)
    del qpp, fp
    counts = {k: counts[k] + q_counts[k] for k in counts}

    # ---- times --------------------------------------------------------- #
    # forward ms per batch (CUDA events); predict utt/s with bf16 and int8
    # alternating ABBA so that clock drift falls on both alike
    pp = Predictor(params, plain_cfg, memory, tok, quantize="none", **kw)
    card = card_line()
    for bucket, req in zip(BUCKETS, reqs):
        packed = kp._pack([u.split() for u in req[:BATCH]])
        ids = torch.from_numpy(packed.input_ids).to(dev)
        mask = torch.from_numpy(packed.attn_mask).to(dev)
        segs = torch.zeros_like(ids)
        k_ms = cuda_ms(lambda: kp._forward(ids, mask, segs))
        q_ms = cuda_ms(lambda: qp._forward(ids, mask, segs))
        p_ms = cuda_ms(lambda: pp._forward(ids, mask, segs), iters=3)
        kp.predict(req)
        qp.predict(req)
        torch.cuda.synchronize()
        reps, secs = 3, {"none": 0.0, "int8": 0.0}
        for p in (kp, qp, qp, kp):
            t0 = time.perf_counter()
            for _ in range(reps):
                p.predict(req)
            secs[p.quantize] += time.perf_counter() - t0
        ups = {m: 2 * reps * len(req) / t for m, t in secs.items()}
        log(f"[times] bucket {bucket}: forward per batch of {BATCH}: bf16 "
            f"kernel {k_ms:.3f} ms, int8 kernel {q_ms:.3f} ms, bf16 plain "
            f"{p_ms:.3f} ms; predict bf16 {ups['none']:.1f} utt/s, int8 "
            f"{ups['int8']:.1f} utt/s ({len(req)} utt/request, ABBA) "
            f"[{card}]")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py runs the "
                           "port on an NVIDIA GPU and nowhere else")
    sys.path.insert(0, REPO)
    from nbest_asr_tpu_torch.ops import _cuda

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 GEMMs in f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] {card}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _cuda.lib()
    log(f"[device] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{_cuda.build_seconds if _cuda.build_seconds is not None else 0:.2f}"
        f" s) -> {_cuda.library_path().name}")

    max_err, times = phase_kernels(dev, card)
    counts = phase_slice(dev)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
         "replaces": KERNEL_REPLACES[name], "launches": counts[name],
         "max_abs_err": max_err[name],
         "ms": times[(name, BUCKETS[-1])][0],
         "plain_ms": times[(name, BUCKETS[-1])][1]}
        for name in _cuda.KERNELS]}
    log("[record] launches: the bf16 and the int8 main-path runs "
        "together; ms/plain_ms: one encoder layer's launches of the kernel "
        f"at batch {BATCH} x seq {BUCKETS[-1]}, BERT-base, bf16 activations")
    log(json.dumps(record))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
