"""On-card kernel validation -- the GPU twin of ``tools/tpu_kernel_check.py``.

Runs the JAX tool's 80 checks by their names, each holding the port's
kernel path on the card (``ops/``'s Functions and wrappers, which launch
the hand-written kernels of ``csrc/``) against the port's plain version of
the same function on the same inputs, where the JAX tool held its Pallas
kernels to an XLA oracle.  Run after touching anything under
``nbest_asr_tpu_torch/csrc`` or ``ops/``.

Usage: python -m nbest_asr_tpu_torch.tools.gpu_kernel_check
           [--record [PATH]] [--platform cpu]

Prints one PASS/FAIL line per check and exits non-zero on any failure.
``--record`` (default path ``GPUCHECK.json``) writes ``TPUCHECK.json``'s
keys -- ``skipped``, ``platform`` ("gpu"), ``device``, ``elapsed_s``,
``all_pass``, ``n_checks``, ``failures``, ``checks`` (per check ``name``,
``ok``, ``value``) -- plus ``power_limit`` (``nvidia-smi``'s name and
power limit), each check's kernel ``launches`` and the run's launch
counts.  Without CUDA the tool returns 2 and writes nothing (the JAX tool
prints SKIP and exits 0); ``--platform cpu`` runs the checks on the CPU,
where every wrapper runs its plain version (a rehearsal of the control
flow, no kernel), and refuses ``--record``.

Tolerances are JAX's: ``check``'s atol and ``check_rel``'s rtol at the
same values, the drop fractions within 0.01 of the rate, determinism bit
for bit.  JAX ran the flash, attention-block and FFN-block checks that
use ``check`` in f32; the port's kernels for them take bf16 activations
only, so they run in bf16, and where both tensors are bf16 the atol is
JAX's plus two bf16 ulps at the tensor's largest magnitude
(``BF16_ALLOWANCE``; ``chip_smoke.py``'s ``Checker`` holds the same
kernels to those two ulps).  The row kernels (fused LN, GELU, embedding)
take f32 and keep JAX's f32 atol alone.

Where JAX extracted a dropout mask from a kernel's output under
degenerate weights, the port reads the mask the same way (one-hot V for
the attention probs, constant biases for the FFN and out-projection
epilogues) from its kernels' forward and backward outputs, and holds it
to the mask ``ops/philox.py`` regenerates, keyed as the kernels key it;
the "extracted-mask oracle" is the plain version, which draws that same
Philox mask.  The flash dropout suites run at JAX's head dims, d = s =
128 single-block and d = s = 256 tiled.

Checks by the port's own names (``PORT_CHECKS``): the extracted masks
against Philox; the flash route at every head dim of ``HEAD_DIM_CHECKS``
-- each ``mma.sync`` instance width and head dims between them, which run
on the next wider instance with zero columns -- forward and gradients
with prob dropout against the plain versions, per route; and, on the
card, that each kernel of ``_cuda.KERNELS`` was launched by the check
``COVERAGE`` names for it.  No JAX check is left out (``OMITTED`` is
empty).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import _cuda
from .pretrain_mlm import resolve_device

BF16_ALLOWANCE = 2.0 ** -6

# every check in the order it runs; the port's own names are PORT_CHECKS
CHECK_NAMES = (
    "flash_attention fwd (single-block)", "flash_attention fwd (tiled)",
    "flash_attention dq", "flash_attention dk", "flash_attention dv",
    "flash_dropout determinism", "flash_dropout drop fraction",
    "flash_dropout mask equals Philox",
    "flash_dropout fwd vs masked oracle", "flash_dropout dq",
    "flash_dropout dk", "flash_dropout dv",
    "flash_dropout (tiled) determinism",
    "flash_dropout (tiled) drop fraction",
    "flash_dropout (tiled) mask equals Philox",
    "flash_dropout (tiled) fwd vs masked oracle",
    "flash_dropout (tiled) dq", "flash_dropout (tiled) dk",
    "flash_dropout (tiled) dv",
    "flash_attention head dims (single-block)",
    "flash_attention head dims (tiled)",
    "fused_ln fwd", "fused_ln dx", "fused_gelu fwd", "fused_gelu dx",
    "fused_embed fwd",
    "fused_ffn fwd", "fused_ffn dx (bf16)", "fused_ffn dw1 (bf16)",
    "fused_ffn dw2 (bf16)", "fused_ffn dropout determinism",
    "fused_ffn dropout variation", "fused_ffn dropout grads finite",
    "fused_ffn mask1 drop fraction", "fused_ffn mask2 drop fraction",
    "fused_ffn fwd/bwd masks equal Philox",
    "fused_ffn dropout fwd vs extracted-mask oracle",
    "fused_ffn dropout dx vs extracted-mask oracle",
    "fused_ffn dropout dw1 vs extracted-mask oracle",
    "fused_ffn dropout dw2 vs extracted-mask oracle",
    "int8_train fwd vs quantized XLA chain", "int8_train is quantized",
    "int8_train dx vs straight-through oracle",
    "int8_train dw1 vs straight-through oracle",
    "int8_train dw2 vs straight-through oracle",
    "int8_train dropout determinism",
    "int8_train_bwd dx vs quantized-gradient oracle",
    "int8_train_bwd dw1 vs quantized-gradient oracle",
    "int8_train_bwd dw2 vs quantized-gradient oracle",
    "int8_train_bwd dropout-grad determinism",
    "fused_attn fwd (s=96 asym pad)", "fused_attn dx (bf16)",
    "fused_attn dwqkv (bf16)", "fused_attn dwo (bf16)",
    "fused_attn attn drop fraction", "fused_attn hidden drop fraction",
    "fused_attn fwd/bwd mask consistency", "fused_attn masks equal Philox",
    "fused_attn dropout fwd vs extracted-mask oracle",
    "fused_attn dropout dx vs extracted-mask oracle",
    "fused_attn dropout dwqkv vs extracted-mask oracle",
    "fused_attn dropout dwo vs extracted-mask oracle",
    "fused_attn dropout determinism", "fused_attn dropout varies by key",
    "int8_train_attn fwd vs quantized XLA chain",
    "int8_train_attn is quantized",
    "int8_train_attn dx vs straight-through oracle",
    "int8_train_attn dwqkv vs straight-through oracle",
    "int8_train_attn dwo vs straight-through oracle",
    "int8_train_attn dropout determinism",
    "int8_train_bwd attn dx vs quantized-grad oracle",
    "int8_train_bwd attn dwqkv vs quantized-grad oracle",
    "int8_train_bwd attn dwo vs quantized-grad oracle",
    "int8_ffn_block vs dense_int8 oracle",
    "int8_attention_block vs dense_int8 oracle",
    "flash_attention segment fwd (single-block)",
    "flash_attention segment fwd (tiled)", "flash_attention segment dq",
    "flash_attention segment dk", "flash_attention segment dv",
    "fused_attn segment fwd", "fused_attn segment dx (bf16)",
    "fused_attn segment dwqkv (bf16)", "fused_attn segment dwo (bf16)",
    "int8_train_attn segment fwd vs quantized chain",
    "int8_attention_block segment fwd vs dense_int8 oracle",
    "every kernel launched by its check",
)
PORT_CHECKS = ("flash_dropout mask equals Philox",
               "flash_dropout (tiled) mask equals Philox",
               "flash_attention head dims (single-block)",
               "flash_attention head dims (tiled)",
               "fused_ffn fwd/bwd masks equal Philox",
               "fused_attn masks equal Philox",
               "every kernel launched by its check")
CUDA_ONLY = ("every kernel launched by its check",)
OMITTED: dict = {}      # JAX check name -> why the port has none
JAX_CHECKS = tuple(n for n in CHECK_NAMES if n not in PORT_CHECKS)
# the port's head-dim checks: the mma.sync instances' widths (32, 96, 128,
# 192, 256; 64 is the wgmma kernels', which JAX's checks cover) and head
# dims between them (16 on the 32-wide instance, 48 on 64, 80 on 96, 136
# on 192, 224 on 256)
HEAD_DIM_CHECKS = (16, 32, 48, 80, 96, 128, 136, 192, 224, 256)

# each kernel of _cuda.KERNELS -> the check whose run launches it first
COVERAGE = {
    "seg_attention": "flash_attention fwd (single-block)",
    "flash_fwd": "flash_attention fwd (tiled)",
    "seg_attention_bwd": "flash_attention dq",
    "flash_bwd_dq": "flash_dropout (tiled) dq",
    "flash_bwd_dkv": "flash_dropout (tiled) dq",
    "residual_layer_norm": "fused_ln fwd",
    "residual_layer_norm_bwd": "fused_ln dx",
    "bias_gelu": "fused_gelu fwd",
    "bias_gelu_bwd": "fused_gelu dx",
    "embed_lookup": "fused_embed fwd",
    "gemm_bias_act": "fused_ffn fwd",
    "gemm_bias_residual": "fused_ffn fwd",
    "layer_norm": "fused_ffn fwd",
    "ffn_bwd_rows": "fused_ffn dx (bf16)",
    "gemm_dgrad": "fused_ffn dx (bf16)",
    "quantize_rows": "int8_train fwd vs quantized XLA chain",
    "gemm_i8_bias_act": "int8_train fwd vs quantized XLA chain",
    "gemm_i8_bias_residual": "int8_train fwd vs quantized XLA chain",
    "quantize_grad_rows": "int8_train_bwd dx vs quantized-gradient oracle",
    "gemm_i8_dgrad": "int8_train_bwd dx vs quantized-gradient oracle",
}


class Checks:
    """The run's results: each check's name, verdict, measured value and
    the kernel launches since the previous check."""

    def __init__(self):
        self.results: list = []
        self.failures: list = []
        self._seen = dict(_cuda.launch_counts)

    def record(self, name: str, ok: bool, value: float) -> None:
        now = dict(_cuda.launch_counts)
        launched = {k: now[k] - self._seen[k] for k in now
                    if now[k] != self._seen[k]}
        self._seen = now
        self.results.append({"name": name, "ok": bool(ok),
                             "value": float(value), "launches": launched})
        if not ok:
            self.failures.append(name)

    def flag(self, name: str, ok: bool, value: float, text: str) -> None:
        print(f"{'PASS' if ok else 'FAIL'}  {name}{text}", flush=True)
        self.record(name, ok, value)

    def check(self, name, got, want, atol: float) -> None:
        """max |got - want| <= atol; for bf16 tensors (and atol > 0) plus
        ``BF16_ALLOWANCE`` times max |want|."""
        g, w = got.float(), want.float()
        diff = float((g - w).abs().max())
        lim = atol
        if atol > 0 and got.dtype == want.dtype == torch.bfloat16:
            lim = atol + BF16_ALLOWANCE * float(w.abs().max())
        ok = diff <= lim and bool(torch.isfinite(g).all())
        self.flag(name, ok, diff,
                  f": max diff {diff:.2e} (atol {atol:g}"
                  + (f", {lim:.2e} in bf16)" if lim != atol else ")"))

    def check_rel(self, name, got, want, rtol: float) -> None:
        g, w = got.float(), want.float()
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-9)
        ok = rel < rtol and bool(torch.isfinite(g).all())
        self.flag(name, ok, rel, f": rel max diff {rel:.2e} (< {rtol:g})")

    def fraction(self, name, keep: torch.Tensor, rate: float) -> None:
        frac = 1.0 - float(keep.float().mean())
        self.flag(name, abs(frac - rate) < 0.01, frac,
                  f": {frac:.4f} (want {rate} ± 0.01)")

    def mismatches(self, name, n: int, what: str) -> None:
        self.flag(name, n == 0, n, f": {n} mismatched bits ({what})")


def _grads(fn, *xs):
    """Gradients of sum(f32(fn(*xs)) ** 2) with respect to ``xs``."""
    xs = [x.detach().requires_grad_(True) for x in xs]
    out = fn(*xs)
    return torch.autograd.grad((out.float() ** 2).sum(), xs)


def _philox(seed: int, stream: int, n_rows: int, n_cols: int, rate: float,
            dev) -> torch.Tensor:
    from ..ops.philox import keep_mask

    return keep_mask(seed, stream, 0, n_rows, n_cols, rate, dev)


def _flash_checks(c: Checks, rng, dev) -> None:
    from ..ops.flash_attention import (flash_attention,
                                       flash_attention_reference)
    from ..ops.philox import STREAM_ATTN_PROB

    def t(a, dtype=torch.bfloat16):
        return torch.as_tensor(a, dtype=torch.float32).to(dev, dtype)

    b, s, h, d = 4, 256, 4, 64
    q, k, v = (t(rng.randn(b, s, h, d)) for _ in range(3))
    lens = rng.randint(s // 4, s + 1, (b,))
    mask = t((np.arange(s)[None] < lens[:, None]).astype(np.float32),
             torch.float32)
    m = mask.bool()
    tiled = dict(block_q=128, block_k=128)
    c.check("flash_attention fwd (single-block)",
            flash_attention(q, k, v, mask)[m],
            flash_attention_reference(q, k, v, mask)[m], 5e-5)
    c.check("flash_attention fwd (tiled)",
            flash_attention(q, k, v, mask, **tiled)[m],
            flash_attention_reference(q, k, v, mask, **tiled)[m], 5e-5)

    m4 = mask[:, :, None, None]
    got = _grads(lambda *a: flash_attention(*a, mask) * m4, q, k, v)
    want = _grads(lambda *a: flash_attention_reference(*a, mask) * m4,
                  q, k, v)
    for a, b_, nm in zip(got, want, "qkv"):
        c.check(f"flash_attention d{nm}", a, b_, 2e-3)

    # in-kernel dropout: with V one-hot over a chunk of d keys, the
    # output IS that chunk of the dropped normalized probs D, whose zero
    # pattern is the kernel's keep-mask; the plain version draws the
    # Philox mask the kernels key on (row (b * heads + h) * s + q,
    # column k) -- forward and all three gradients must match it
    def dropout_suite(tag, sd, dd, block_kw):
        qd, kd = (t(rng.randn(2, sd, 2, dd)) for _ in range(2))
        mask_d = torch.ones((2, sd), dtype=torch.float32, device=dev)
        rate, seed = 0.3, 7

        def drop(q_, k_, v_, fn=flash_attention):
            return fn(q_, k_, v_, mask_d, dropout_rate=rate, seed=seed,
                      **block_kw)

        def extract():
            chunks = []
            for j0 in range(0, sd, dd):
                e = torch.zeros((2, sd, 2, dd), dtype=torch.bfloat16,
                                device=dev)
                e[:, j0 + torch.arange(dd), :, torch.arange(dd)] = 1.0
                chunks.append(drop(qd, kd, e))
            return torch.cat(chunks, dim=-1)        # (b, q, h, k)

        d_mat = extract()
        c.check(f"flash_dropout{tag} determinism", extract(), d_mat, 0.0)
        keep = d_mat.permute(0, 2, 1, 3) != 0       # (b, h, q, k)
        c.fraction(f"flash_dropout{tag} drop fraction", keep, rate)
        want_keep = _philox(seed, STREAM_ATTN_PROB, 2 * 2 * sd, sd, rate,
                            dev).reshape(keep.shape)
        c.mismatches(f"flash_dropout{tag} mask equals Philox",
                     int((keep != want_keep).sum()),
                     "the kernel's keep bits against Philox stream 3")

        vd = t(rng.randn(2, sd, 2, dd))
        c.check(f"flash_dropout{tag} fwd vs masked oracle",
                drop(qd, kd, vd),
                drop(qd, kd, vd, flash_attention_reference), 5e-5)
        gd = _grads(drop, qd, kd, vd)
        go = _grads(lambda *a: drop(*a, fn=flash_attention_reference),
                    qd, kd, vd)
        for a, b_, nm in zip(gd, go, "qkv"):
            c.check(f"flash_dropout{tag} d{nm}", a, b_, 2e-3)

    dropout_suite("", 128, 128, {})
    dropout_suite(" (tiled)", 256, 256, tiled)

    # every head dim of HEAD_DIM_CHECKS on each route, prob dropout 0.1:
    # the output and dq, dk, dv against the plain versions, each within
    # check()'s bf16 limit (atol 5e-5 forward, 2e-3 gradients); the value
    # is the worst ratio of a difference to its limit
    def held(got, want, atol):
        lim = atol + BF16_ALLOWANCE * float(want.float().abs().max())
        ok = bool(torch.isfinite(got.float()).all())
        return float((got.float() - want.float()).abs().max()) / lim, ok

    for route, kw, sh in (("single-block", {}, 160), ("tiled", tiled, 320)):
        worst, finite = 0.0, True
        for dh in HEAD_DIM_CHECKS:
            qh, kh, vh = (t(rng.randn(2, sh, 2, dh)) for _ in range(3))
            mh = torch.ones((2, sh), dtype=torch.float32, device=dev)
            mh[1, 2 * sh // 3:] = 2.0

            def fh(q_, k_, v_, fn=flash_attention):
                return fn(q_, k_, v_, mh, dropout_rate=0.1, seed=11 + dh,
                          **kw)

            pairs = [(fh(qh, kh, vh), fh(qh, kh, vh,
                                         flash_attention_reference), 5e-5)]
            pairs += [(a, b_, 2e-3) for a, b_ in zip(
                _grads(fh, qh, kh, vh),
                _grads(lambda *a: fh(*a, fn=flash_attention_reference),
                       qh, kh, vh))]
            for got_, want_, atol in pairs:
                r, ok = held(got_, want_, atol)
                worst, finite = max(worst, r), finite and ok
        c.flag(f"flash_attention head dims ({route})", worst <= 1.0 and finite,
               worst, f": worst {worst:.3f} of the limit over d in "
               f"{HEAD_DIM_CHECKS}, s {sh}")


def _row_checks(c: Checks, rng, dev) -> None:
    from ..ops.fused_embed import fused_embed_lookup
    from ..ops.fused_gelu import fused_bias_gelu
    from ..ops.fused_ln import fused_residual_layer_norm
    from ..ops.layers import gelu, layer_norm

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a).to(dev, dtype)

    x, r = t(rng.randn(2048, 768)), t(rng.randn(2048, 768))
    sc, bi = t(rng.rand(768) + 0.5), t(rng.randn(768))
    c.check("fused_ln fwd", fused_residual_layer_norm(x, r, sc, bi),
            layer_norm(x + r, sc, bi), 1e-4)
    g1, = _grads(lambda a: fused_residual_layer_norm(a, r, sc, bi), x)
    g2, = _grads(lambda a: layer_norm(a + r, sc, bi), x)
    c.check("fused_ln dx", g1, g2, 2e-3)

    xg, bg = t(rng.randn(2048, 3072)), t(rng.randn(3072))
    c.check("fused_gelu fwd", fused_bias_gelu(xg, bg), gelu(xg + bg), 1e-4)
    g1, = _grads(lambda a: fused_bias_gelu(a, bg), xg)
    g2, = _grads(lambda a: gelu(a + bg), xg)
    c.check("fused_gelu dx", g1, g2, 2e-3)

    V, P, T, hh = 30522, 512, 2, 768
    word, pos, typ = (t(rng.randn(n, hh).astype(np.float32))
                      for n in (V, P, T))
    esc = t(rng.rand(hh).astype(np.float32) + 0.5)
    ebi = t(rng.randn(hh).astype(np.float32))
    bb, ss = 16, 64
    ids = t(rng.randint(0, V, (bb, ss)), torch.int32)
    tids = t(rng.randint(0, T, (bb, ss)), torch.int32)
    posids = torch.arange(ss, device=dev)[None].expand(bb, ss)
    want = layer_norm(word[ids.long()] + pos[posids] + typ[tids.long()],
                      esc, ebi, 1e-12)
    c.check("fused_embed fwd",
            fused_embed_lookup(word, pos, typ, esc, ebi, ids, tids, ss),
            want, 1e-4)


def _ffn_checks(c: Checks, rng, dev) -> torch.Tensor:
    from ..ops import kernels as K
    from ..ops.fused_ffn import (fused_ffn_block, fused_ffn_block_int8_train,
                                 fused_ffn_block_int8_train_reference,
                                 fused_ffn_block_reference)
    from ..ops.philox import STREAM_HIDDEN, STREAM_INTER, site

    def t(a, dtype=torch.bfloat16):
        return torch.as_tensor(a, dtype=torch.float32).to(dev, dtype)

    f32 = torch.float32
    nf, hf, itf = 512, 768, 3072
    xb = t(rng.randn(nf, hf) * 0.5)
    w1b = t(rng.randn(hf, itf) * 0.05)
    fb1 = t(rng.randn(itf) * 0.02, f32)
    w2b = t(rng.randn(itf, hf) * 0.05)
    fb2 = t(rng.randn(hf) * 0.02, f32)
    fls = t(1.0 + 0.1 * rng.randn(hf), f32)
    flb = t(0.1 * rng.randn(hf), f32)

    def block(fn, **kw):
        return lambda x_, a_, c_: fn(x_, a_, fb1, c_, fb2, fls, flb, **kw)

    got_f = fused_ffn_block(xb, w1b, fb1, w2b, fb2, fls, flb)
    c.check("fused_ffn fwd", got_f,
            fused_ffn_block_reference(xb, w1b, fb1, w2b, fb2, fls, flb),
            1e-4)
    gf = _grads(block(fused_ffn_block), xb, w1b, w2b)
    gr = _grads(block(fused_ffn_block_reference), xb, w1b, w2b)
    for a, b_, nm in zip(gf, gr, ("dx", "dw1", "dw2")):
        c.check_rel(f"fused_ffn {nm} (bf16)", a, b_, 0.05)

    def ffn_drop(seed):
        return fused_ffn_block(xb, w1b, fb1, w2b, fb2, fls, flb,
                               dropout_rate=0.3, seed=seed)

    d1, d2, d3 = ffn_drop(3), ffn_drop(3), ffn_drop(4)
    c.check("fused_ffn dropout determinism", d1, d2, 0.0)
    varies = float((d1.float() - d3.float()).abs().max()) > 1e-3
    changes = float((d1.float() - got_f.float()).abs().max()) > 1e-3
    c.flag("fused_ffn dropout variation", varies and changes,
           float(varies and changes),
           " varies by key and differs from no-drop")
    gd_ = _grads(block(fused_ffn_block, dropout_rate=0.3, seed=5),
                 xb, w1b, w2b)
    ok_fin = all(bool(torch.isfinite(g).all()) for g in gd_)
    c.flag("fused_ffn dropout grads finite", ok_fin, float(ok_fin), "")

    # the FFN's masks read from its kernels under degenerate weights:
    # w1 = 0 and b1 = 4 make gd = mask1 * gelu(4) / keep, in the forward
    # and in the backward's regenerated gd; w2 = 0 and b2 = 4 make the
    # forward's y2d = mask2 * 4 / keep; the backward's dy2 is mask2 * ds
    rate_f, seed_f, nf2 = 0.3, 11, 384
    dr1 = site(seed_f, rate_f, STREAM_INTER)
    dr2 = site(seed_f, rate_f, STREAM_HIDDEN)
    xfb = t(rng.randn(nf2, hf) * 0.5)
    zero_w1 = torch.zeros((hf, itf), dtype=torch.bfloat16, device=dev)
    zero_w2 = torch.zeros((itf, hf), dtype=torch.bfloat16, device=dev)
    four_i = torch.full((itf,), 4.0, dtype=f32, device=dev)
    four_h = torch.full((hf,), 4.0, dtype=f32, device=dev)
    ones_h = torch.ones((hf,), dtype=f32, device=dev)
    zeros_h = torch.zeros((hf,), dtype=f32, device=dev)
    h_, gd_f = K.gemm_bias_act(xfb, zero_w1, four_i, "gelu", drop=dr1,
                               save_h=True)
    s_, y2d = K.gemm_bias_residual(gd_f, zero_w2, four_h, xfb, drop=dr2,
                                   save_y2d=True)
    _, mean0, rstd0 = K.layer_norm_rows(s_, ones_h, zeros_h, 1e-12,
                                        torch.bfloat16, stats=True)
    dy_rand = t(rng.randn(nf2, hf))
    dy2, _, ds = K.ffn_bwd_rows(xfb, y2d, dy_rand, ones_h, mean0, rstd0,
                                drop=dr2)
    _, gd_b = K.gemm_dgrad(dy2, zero_w2, "dgelu", h=h_, drop=dr1)
    mask1, mask2 = gd_b != 0, y2d != 0
    c.fraction("fused_ffn mask1 drop fraction", mask1, rate_f)
    c.fraction("fused_ffn mask2 drop fraction", mask2, rate_f)
    keep1 = _philox(seed_f, STREAM_INTER, nf2, itf, rate_f, dev)
    keep2 = _philox(seed_f, STREAM_HIDDEN, nf2, hf, rate_f, dev)
    n_bad = int((mask1 != keep1).sum() + ((gd_f != 0) != keep1).sum()
                + (mask2 != keep2).sum()
                + ((dy2 != 0) != (keep2 & (ds != 0))).sum())
    c.mismatches("fused_ffn fwd/bwd masks equal Philox", n_bad,
                 "forward gd and y2d, backward gd and dy2, against Philox "
                 "streams 1 and 2")

    w1r, w2r = t(rng.randn(hf, itf) * 0.05), t(rng.randn(itf, hf) * 0.05)
    kw = dict(dropout_rate=rate_f, seed=seed_f)
    c.check_rel("fused_ffn dropout fwd vs extracted-mask oracle",
                block(fused_ffn_block, **kw)(xfb, w1r, w2r),
                block(fused_ffn_block_reference, **kw)(xfb, w1r, w2r), 0.02)
    gm = _grads(block(fused_ffn_block, **kw), xfb, w1r, w2r)
    go = _grads(block(fused_ffn_block_reference, **kw), xfb, w1r, w2r)
    for a, b_, nm in zip(gm, go, ("dx", "dw1", "dw2")):
        c.check_rel(f"fused_ffn dropout {nm} vs extracted-mask oracle",
                    a, b_, 0.05)

    # int8-forward training FFN: the quantized chain and its
    # straight-through backward, on the kernels against the same
    # Function on the plain versions
    i8, i8_ref = fused_ffn_block_int8_train, \
        fused_ffn_block_int8_train_reference
    got_i8 = block(i8)(xb, w1b, w2b)
    c.check_rel("int8_train fwd vs quantized XLA chain", got_i8,
                block(i8_ref)(xb, w1b, w2b), 0.02)
    diff_q = float((got_i8.float() - got_f.float()).abs().max())
    c.flag("int8_train is quantized", diff_q > 1e-3, diff_q,
           f" (differs from bf16 fwd by {diff_q:.2e})")
    g_i8 = _grads(block(i8), xb, w1b, w2b)
    g_i8o = _grads(block(i8_ref), xb, w1b, w2b)
    for a, b_, nm in zip(g_i8, g_i8o, ("dx", "dw1", "dw2")):
        c.check_rel(f"int8_train {nm} vs straight-through oracle", a, b_,
                    0.05)
    i1 = block(i8, dropout_rate=0.3, seed=3)(xb, w1b, w2b)
    i2 = block(i8, dropout_rate=0.3, seed=3)(xb, w1b, w2b)
    c.check("int8_train dropout determinism", i1, i2, 0.0)

    g_i8b = _grads(block(i8, int8_bwd=True), xb, w1b, w2b)
    g_i8bo = _grads(block(i8_ref, int8_bwd=True), xb, w1b, w2b)
    for a, b_, nm in zip(g_i8b, g_i8bo, ("dx", "dw1", "dw2")):
        c.check_rel(f"int8_train_bwd {nm} vs quantized-gradient oracle",
                    a, b_, 0.05)
    kw = dict(dropout_rate=0.3, seed=5, int8_bwd=True)
    ib1, = _grads(lambda x_: block(i8, **kw)(x_, w1b, w2b), xb)
    ib2, = _grads(lambda x_: block(i8, **kw)(x_, w1b, w2b), xb)
    c.check("int8_train_bwd dropout-grad determinism", ib1, ib2, 0.0)
    return got_f


def _attn_checks(c: Checks, rng, dev) -> None:
    from ..ops import kernels as K
    from ..ops.fused_attention import (
        fused_attention_block, fused_attention_block_int8_train,
        fused_attention_block_int8_train_reference,
        fused_attention_block_reference)
    from ..ops.philox import STREAM_ATTN_HIDDEN, STREAM_ATTN_PROB, site

    def t(a, dtype=torch.bfloat16):
        return torch.as_tensor(a, dtype=torch.float32).to(dev, dtype)

    f32, bf = torch.float32, torch.bfloat16
    ha, nha, da = 768, 12, 64
    ba, sa = 4, 96
    xab = t(rng.randn(ba, sa, ha) * 0.5)
    wqb = t(rng.randn(ha, 3 * ha) * 0.05)
    bqkv = t(rng.randn(3 * ha) * 0.02, f32)
    wob = t(rng.randn(ha, ha) * 0.05)
    bo_a = t(rng.randn(ha) * 0.02, f32)
    ls_a = t(1.0 + 0.1 * rng.randn(ha), f32)
    lb_a = t(0.1 * rng.randn(ha), f32)
    mk_np = (rng.rand(ba, sa) > 0.2).astype(np.float32)
    mk_np[:, 0] = 1.0
    mk_a = t(mk_np, f32)

    def block(fn, mask, **kw):
        return lambda x_, a_, c_: fn(x_, a_, bqkv, c_, bo_a, ls_a, lb_a,
                                     mask, n_heads=nha, **kw)

    c.check("fused_attn fwd (s=96 asym pad)",
            block(fused_attention_block, mk_a)(xab, wqb, wob),
            block(fused_attention_block_reference, mk_a)(xab, wqb, wob),
            1e-4)
    ga = _grads(block(fused_attention_block, mk_a), xab, wqb, wob)
    gao = _grads(block(fused_attention_block_reference, mk_a), xab, wqb,
                 wob)
    for a, b_, nm in zip(ga, gao, ("dx", "dwqkv", "dwo")):
        c.check_rel(f"fused_attn {nm} (bf16)", a, b_, 0.05)

    # the masks read from the chain's kernels: Wq = Wk = 0 give uniform
    # probs and a one-hot V (d = s = 64) makes the forward's ctx the
    # dropped probs; a one-hot dctx makes the backward's dv their
    # transpose; Wo = 0 and bo = 4 make the out-projection's od the
    # hidden keep-mask times 4 / keep, and the backward's dout is that
    # mask times ds
    rate_a, seed_a, sa2, bp = 0.3, 13, 64, 4
    da_ = site(seed_a, rate_a, STREAM_ATTN_PROB)
    dh_ = site(seed_a, rate_a, STREAM_ATTN_HIDDEN)
    eye = torch.eye(sa2, dtype=bf, device=dev)
    qkv = torch.zeros((bp, sa2, 3, nha, da), dtype=bf, device=dev)
    qkv[:, :, 2] = eye[None, :, None, :]
    qkv = qkv.reshape(bp * sa2, 3 * ha)
    mask_full = torch.ones((bp, sa2), dtype=f32, device=dev)
    ctx, st = K.seg_attention(qkv, mask_full, nha, drop=da_, stats=True)
    dctx = eye[None, :, None, :].expand(bp, sa2, nha, da).reshape(
        bp * sa2, ha).contiguous()
    dqkv = K.seg_attention_bwd(qkv, dctx, mask_full, st, nha, drop=da_)
    attn_fwd = ctx.reshape(bp, sa2, nha, da).permute(0, 2, 1, 3) != 0
    attn_bwd = dqkv.reshape(bp, sa2, 3, nha, da)[:, :, 2].permute(
        0, 2, 3, 1) != 0                            # (b, h, q, k)
    x2 = t(rng.randn(bp * sa2, ha) * 0.5)
    zero_wo = torch.zeros((ha, ha), dtype=bf, device=dev)
    four_h = torch.full((ha,), 4.0, dtype=f32, device=dev)
    ones_h = torch.ones((ha,), dtype=f32, device=dev)
    zeros_h = torch.zeros((ha,), dtype=f32, device=dev)
    s_, od = K.gemm_bias_residual(ctx, zero_wo, four_h, x2, drop=dh_,
                                  save_y2d=True)
    _, mean_a, rstd_a = K.layer_norm_rows(s_, ones_h, zeros_h, 1e-12, bf,
                                          stats=True)
    dout, _, ds = K.ffn_bwd_rows(x2, od, t(rng.randn(bp * sa2, ha)), ones_h,
                                 mean_a, rstd_a, drop=dh_)
    hid_fwd = od != 0
    c.fraction("fused_attn attn drop fraction", attn_fwd, rate_a)
    c.fraction("fused_attn hidden drop fraction", hid_fwd, rate_a)
    n_mis = int((attn_fwd != attn_bwd).sum()
                + ((dout != 0) != (hid_fwd & (ds != 0))).sum())
    c.mismatches("fused_attn fwd/bwd mask consistency", n_mis,
                 "the forward's attention and hidden keep bits against the "
                 "backward's")
    keep_a = _philox(seed_a, STREAM_ATTN_PROB, bp * nha * sa2, sa2, rate_a,
                     dev).reshape(attn_fwd.shape)
    keep_h = _philox(seed_a, STREAM_ATTN_HIDDEN, bp * sa2, ha, rate_a, dev)
    c.mismatches("fused_attn masks equal Philox",
                 int((attn_fwd != keep_a).sum() + (hid_fwd != keep_h).sum()),
                 "against Philox streams 3 and 4")

    xr = t(rng.randn(bp, sa2, ha) * 0.5)
    wqr, wor = t(rng.randn(ha, 3 * ha) * 0.05), t(rng.randn(ha, ha) * 0.05)
    mk_ones = torch.ones((bp, sa2), dtype=f32, device=dev)
    kw = dict(attn_dropout=rate_a, hidden_dropout=rate_a, seed=seed_a)
    c.check_rel("fused_attn dropout fwd vs extracted-mask oracle",
                block(fused_attention_block, mk_ones, **kw)(xr, wqr, wor),
                block(fused_attention_block_reference, mk_ones, **kw)(
                    xr, wqr, wor), 0.02)
    gm = _grads(block(fused_attention_block, mk_ones, **kw), xr, wqr, wor)
    go = _grads(block(fused_attention_block_reference, mk_ones, **kw),
                xr, wqr, wor)
    for a, b_, nm in zip(gm, go, ("dx", "dwqkv", "dwo")):
        c.check_rel(f"fused_attn dropout {nm} vs extracted-mask oracle",
                    a, b_, 0.05)

    def fab_drop(seed):
        return block(fused_attention_block, mk_ones, attn_dropout=rate_a,
                     hidden_dropout=rate_a, seed=seed)(xr, wqr, wor)

    da1, da2, da3 = fab_drop(seed_a), fab_drop(seed_a), fab_drop(14)
    c.check("fused_attn dropout determinism", da1, da2, 0.0)
    ok_var = float((da1.float() - da3.float()).abs().max()) > 1e-3
    c.flag("fused_attn dropout varies by key", ok_var, float(ok_var), "")

    # int8-forward training attention, then its int8 backward
    i8, i8_ref = fused_attention_block_int8_train, \
        fused_attention_block_int8_train_reference
    got_ai = block(i8, mk_a)(xab, wqb, wob)
    c.check_rel("int8_train_attn fwd vs quantized XLA chain", got_ai,
                block(i8_ref, mk_a)(xab, wqb, wob), 0.02)
    bf16_afwd = block(fused_attention_block, mk_a)(xab, wqb, wob)
    diff_aq = float((got_ai.float() - bf16_afwd.float()).abs().max())
    c.flag("int8_train_attn is quantized", diff_aq > 1e-3, diff_aq,
           f" (differs from bf16 fwd by {diff_aq:.2e})")
    g_ai = _grads(block(i8, mk_a), xab, wqb, wob)
    g_aio = _grads(block(i8_ref, mk_a), xab, wqb, wob)
    for a, b_, nm in zip(g_ai, g_aio, ("dx", "dwqkv", "dwo")):
        c.check_rel(f"int8_train_attn {nm} vs straight-through oracle",
                    a, b_, 0.05)
    kw = dict(attn_dropout=rate_a, hidden_dropout=rate_a, seed=seed_a)
    c.check("int8_train_attn dropout determinism",
            block(i8, mk_a, **kw)(xab, wqb, wob),
            block(i8, mk_a, **kw)(xab, wqb, wob), 0.0)
    g_aib = _grads(block(i8, mk_a, int8_bwd=True), xab, wqb, wob)
    g_aibo = _grads(block(i8_ref, mk_a, int8_bwd=True), xab, wqb, wob)
    for a, b_, nm in zip(g_aib, g_aibo, ("dx", "dwqkv", "dwo")):
        c.check_rel(f"int8_train_bwd attn {nm} vs quantized-grad oracle",
                    a, b_, 0.05)


def _int8_serving(rng, dev):
    """The int8 serving blocks' operands: x (8, 96, 768) bf16, a padded
    mask, and the four weights quantized per output channel, q in the
    CUDA int8 GEMM's layout."""
    from ..ops.quant import kernel_layout, quantize_weight

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=torch.float32).to(dev, dtype)

    def qw(w):
        q, s = quantize_weight(t(w))
        return kernel_layout(q), s

    hq, iq, bq, sq = 768, 3072, 8, 96
    xi = t(rng.randn(bq, sq, hq) * 0.5, torch.bfloat16)
    mk_i = t((np.arange(sq)[None]
              < rng.randint(sq // 2, sq + 1, (bq,))[:, None]))
    w1 = qw(rng.randn(hq, iq) * 0.05)
    w2 = qw(rng.randn(iq, hq) * 0.05)
    wq = qw(rng.randn(hq, 3 * hq) * 0.05)
    wo = qw(rng.randn(hq, hq) * 0.05)
    b1, b2 = t(rng.randn(iq) * 0.1), t(rng.randn(hq) * 0.1)
    bqk, boq = t(rng.randn(3 * hq) * 0.1), t(rng.randn(hq) * 0.1)
    ls, lb = t(1.0 + 0.1 * rng.randn(hq)), t(0.1 * rng.randn(hq))
    return xi, mk_i, (*w1, b1, *w2, b2, ls, lb), (*wq, bqk, *wo, boq, ls, lb)


def _serving_checks(c: Checks, rng, dev):
    from ..ops.int8_serving import (int8_attention_block,
                                    int8_attention_block_reference,
                                    int8_ffn_block, int8_ffn_block_reference)

    xi, mk_i, ffn_w, attn_w = _int8_serving(rng, dev)
    c.check_rel("int8_ffn_block vs dense_int8 oracle",
                int8_ffn_block(xi, *ffn_w),
                int8_ffn_block_reference(xi, *ffn_w), 0.02)
    rows = mk_i.bool()
    c.check_rel("int8_attention_block vs dense_int8 oracle",
                int8_attention_block(xi, *attn_w, mk_i, n_heads=12)[rows],
                int8_attention_block_reference(xi, *attn_w, mk_i,
                                               n_heads=12)[rows], 0.02)
    return xi, attn_w


def _segment_checks(c: Checks, rng, dev, xi, attn_w) -> None:
    """Packed-example (segment) masks through the flash route, the
    attention block in training and the int8 attention blocks."""
    from ..ops.flash_attention import (flash_attention,
                                       flash_attention_reference)
    from ..ops.fused_attention import (
        fused_attention_block, fused_attention_block_int8_train,
        fused_attention_block_int8_train_reference,
        fused_attention_block_reference)
    from ..ops.int8_serving import (int8_attention_block,
                                    int8_attention_block_reference)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=torch.float32).to(dev, dtype)

    bsg, ssg = 4, 256
    seg_np = np.zeros((bsg, ssg), np.float32)
    seg_np[0, : ssg // 3] = 1.0                      # 2 segs + pad tail
    seg_np[0, ssg // 3: 2 * ssg // 3] = 2.0
    seg_np[1, : ssg // 2] = 1.0                      # 1 seg + pad tail
    for j, lo in enumerate(range(0, ssg, ssg // 4)):  # 4 full segs
        seg_np[2, lo: lo + ssg // 4] = float(j + 1)
    seg_np[3, :] = 1.0                               # unpacked row
    seg_m = t(seg_np)
    vsg = seg_m > 0
    qs, ks, vs = (t(rng.randn(bsg, ssg, 4, 64), torch.bfloat16)
                  for _ in range(3))
    tiled = dict(block_q=128, block_k=128)
    c.check("flash_attention segment fwd (single-block)",
            flash_attention(qs, ks, vs, seg_m)[vsg],
            flash_attention_reference(qs, ks, vs, seg_m)[vsg], 5e-5)
    c.check("flash_attention segment fwd (tiled)",
            flash_attention(qs, ks, vs, seg_m, **tiled)[vsg],
            flash_attention_reference(qs, ks, vs, seg_m, **tiled)[vsg],
            5e-5)
    v4 = vsg[:, :, None, None]
    gsf = _grads(lambda *a: flash_attention(*a, seg_m) * v4, qs, ks, vs)
    gsr = _grads(lambda *a: flash_attention_reference(*a, seg_m) * v4,
                 qs, ks, vs)
    for a, b_, nm in zip(gsf, gsr, "qkv"):
        c.check(f"flash_attention segment d{nm}", a, b_, 2e-3)

    # the attention block (training default) on a packed mask, bf16
    ha, nha, ba, sa = 768, 12, 4, 96
    xab = t(rng.randn(ba, sa, ha) * 0.5, torch.bfloat16)
    wqb = t(rng.randn(ha, 3 * ha) * 0.05, torch.bfloat16)
    bqkv = t(rng.randn(3 * ha) * 0.02)
    wob = t(rng.randn(ha, ha) * 0.05, torch.bfloat16)
    bo, ls = t(rng.randn(ha) * 0.02), t(1.0 + 0.1 * rng.randn(ha))
    lb = t(0.1 * rng.randn(ha))
    seg_a_np = np.zeros((ba, sa), np.float32)
    seg_a_np[0, :40] = 1.0
    seg_a_np[0, 40:88] = 2.0
    seg_a_np[1, :50] = 1.0
    for j, lo in enumerate(range(0, sa, sa // 3)):
        seg_a_np[2, lo: lo + sa // 3] = float(j + 1)
    seg_a_np[3, :] = 1.0
    seg_a = t(seg_a_np)
    vsa = seg_a > 0

    def block(fn, masked=False):
        def f(x_, a_, c_):
            y = fn(x_, a_, bqkv, c_, bo, ls, lb, seg_a, n_heads=nha)
            return y * vsa[:, :, None] if masked else y
        return f

    c.check("fused_attn segment fwd",
            block(fused_attention_block)(xab, wqb, wob)[vsa],
            block(fused_attention_block_reference)(xab, wqb, wob)[vsa], 1e-4)
    gfs = _grads(block(fused_attention_block, True), xab, wqb, wob)
    gfso = _grads(block(fused_attention_block_reference, True), xab, wqb,
                  wob)
    for a, b_, nm in zip(gfs, gfso, ("dx", "dwqkv", "dwo")):
        c.check_rel(f"fused_attn segment {nm} (bf16)", a, b_, 0.05)
    c.check_rel("int8_train_attn segment fwd vs quantized chain",
                block(fused_attention_block_int8_train)(xab, wqb, wob)[vsa],
                block(fused_attention_block_int8_train_reference)(
                    xab, wqb, wob)[vsa], 0.02)

    # the int8 serving attention on a packed mask
    bq, sq = xi.shape[:2]
    seg_i_np = np.zeros((bq, sq), np.float32)
    seg_i_np[:, : sq // 2] = 1.0
    seg_i_np[:, sq // 2: 3 * sq // 4] = 2.0
    seg_i_np[0, 3 * sq // 4:] = 3.0
    seg_i = t(seg_i_np)
    rows = seg_i > 0
    c.check_rel("int8_attention_block segment fwd vs dense_int8 oracle",
                int8_attention_block(xi, *attn_w, seg_i, n_heads=12)[rows],
                int8_attention_block_reference(xi, *attn_w, seg_i,
                                               n_heads=12)[rows], 0.02)


def _coverage_check(c: Checks) -> None:
    by_name = {r["name"]: r["launches"] for r in c.results}
    missing = [k for k in _cuda.KERNELS
               if by_name.get(COVERAGE[k], {}).get(k, 0) < 1]
    for k in missing:
        where = [r["name"] for r in c.results if r["launches"].get(k)]
        print(f"  {k}: not launched by {COVERAGE[k]!r}; launched by "
              f"{where}", flush=True)
    c.flag("every kernel launched by its check", not missing, len(missing),
           f": {len(_cuda.KERNELS) - len(missing)} of "
           f"{len(_cuda.KERNELS)} kernels")


def run_checks(dev: torch.device) -> Checks:
    """Every check on ``dev`` (the card; the CPU runs the plain versions
    on both sides); raises if the run's check names differ from
    ``CHECK_NAMES``."""
    rng = np.random.RandomState(0)
    c = Checks()
    _flash_checks(c, rng, dev)
    _row_checks(c, rng, dev)
    _ffn_checks(c, rng, dev)
    _attn_checks(c, rng, dev)
    xi, attn_w = _serving_checks(c, rng, dev)
    _segment_checks(c, rng, dev, xi, attn_w)
    if dev.type == "cuda":
        _coverage_check(c)
    want = [n for n in CHECK_NAMES
            if dev.type == "cuda" or n not in CUDA_ONLY]
    got = [r["name"] for r in c.results]
    if got != want:
        raise AssertionError(f"gpu_kernel_check ran {got}, expected {want}")
    return c


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--record", nargs="?", const="GPUCHECK.json",
                    default=None, metavar="PATH",
                    help="write machine-readable results JSON "
                         "(default GPUCHECK.json)")
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs the checks on the plain versions "
                    "(a rehearsal; no record); anything else, or nothing, "
                    "on the card")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.platform, "gpu_kernel_check")
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if dev.type != "cuda" and args.record:
        print("error: --record needs the card: a CPU run launches no "
              "kernel", file=sys.stderr)
        return 2
    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        _cuda.lib()         # build now: raises if nvcc or a build fails
        print(f"kernels built and loaded in {time.time() - t0:.1f} s",
              flush=True)
    c = run_checks(dev)
    print("ALL PASS" if not c.failures else f"FAILURES: {c.failures}",
          flush=True)
    if args.record:
        payload = {
            "skipped": False,
            "platform": "gpu",
            "device": torch.cuda.get_device_name(dev),
            "power_limit": card_line(),
            "elapsed_s": round(time.time() - t0, 1),
            "all_pass": not c.failures,
            "n_checks": len(c.results),
            "failures": c.failures,
            "checks": c.results,
            "launch_counts": {k: sum(r["launches"].get(k, 0)
                                     for r in c.results)
                              for k in _cuda.KERNELS},
        }
        with open(args.record, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.record}", flush=True)
    return 1 if c.failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
