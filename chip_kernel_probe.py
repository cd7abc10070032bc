#!/usr/bin/env python3
"""Probe one checkout's built kernels on an NVIDIA GPU, to compare two
commits' kernels beyond their times:

    python3 chip_kernel_probe.py --root CHECKOUT sass NAME
    python3 chip_kernel_probe.py --root CHECKOUT ptxas NAME
    python3 chip_kernel_probe.py --root CHECKOUT gelu-dump OUT.pt
    python3 chip_kernel_probe.py --root CHECKOUT attn-dump OUT.pt
    python3 chip_kernel_probe.py compare A.pt B.pt
    python3 chip_kernel_probe.py --root CHECKOUT chunked-variants A.cu ...

``--root`` is the root of a checkout of this repository (default: the
directory of this script); its kernels are built into its own ``build/``.
``sass`` prints, for each kernel instance whose mangled name contains
NAME, its SASS instruction count and, for its longest loop (the body from
a backward branch's target to the branch), the instructions, MUFU
instructions, 32 x 32 -> 64-bit integer multiplies (IMAD.WIDE: Philox's)
and branches in it, from ``cuobjdump -sass`` of the built
library.  ``ptxas`` builds the checkout's kernels afresh (it refuses a
checkout whose library is already built) and prints ptxas's registers
and spill bytes for each kernel instance whose mangled name contains NAME,
as ``chip_smoke.py`` reports them.  ``gelu-dump`` saves ``bias_gelu`` and ``bias_gelu_bwd`` outputs
on fixed inputs: every bf16 value as x (bias 0, and random), in bf16 and
widened to f32; 4 M random f32 bit patterns; random operands with special
values, bf16 and f32, at N % 8 == 0 and N % 8 == 4.  ``attn-dump`` saves
``seg_attention`` (ctx and the row statistics, with and without the prob
dropout) and ``seg_attention_bwd`` (dqkv) on fixed inputs at the shapes
whose kernels a change to the d = 192 instances must leave alone: d = 64
at every bucket, ragged lengths and past 256, on the QKV buffer and on (b,
s, heads, d) tensors; d = 96 at every bucket (its wgmma pair); the
mma.sync instances at d = 32, 80, 128, 136 (on the 192-wide instance) and
at d = 96 and 192 past 256; and the tiled trio (``flash_fwd``: o and
lse; ``flash_bwd_dq``: dq and di; ``flash_bwd_dkv``: dk and dv, and
the pair again on the plain forward's o and lse, so that a change of the
forward leaves the pair's inputs alone) at s = 700 and 1024 on q, k, v
views of one QKV buffer at d = 64 and 96 (their wgmma + TMA instances),
32, 128, 192, 256 and the padded 48 and 80; and the chunked family at d =
12, 258 and 384 (``CHUNKED_CASES``: single-block at s = 77 and 256, tiled
at 700), its backward kernels fed the plain forward's statistics (bit for
bit) and ``chunked_fwd`` held to its plain version by the card tests'
tolerance (a flag in the dump).
``compare`` holds two dumps bit for bit and names the cases that differ.
``chunked-variants`` builds each given copy of ``csrc/attention_chunked.cu``
alone (nvcc, about 30 s, all at once; the checkout's ``csrc`` headers on
the include path) and times its ``chunked_fwd`` at
``chip_time_attention.CHUNKED_SHAPES``, dropout 0.1 and 0, the variants
in turn twice over (A B B A for two), with the largest difference from
the plain version; a variant that exports ``nbk_prof_read(unsigned long
long[8])`` (per-phase ``clock64`` sums of each block's first thread)
also prints those sums per block.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import torch

SPECIAL = [0.0, -0.0, 1e-30, -1e-30, 1e30, -1e30, float("inf"),
           float("-inf"), float("nan"), 5.0, -5.0, 12.0, 3.4e38, -3.4e38,
           1e-45, -1e-45]


def sass(name: str) -> None:
    from nbest_asr_tpu_torch.ops import _cuda

    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(_cuda.build())],
                          capture_output=True, text=True,
                          check=True).stdout
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        fn = block.split("\n", 1)[0].strip()
        if name not in fn:
            continue
        ins = [(int(a, 16), op) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", block)]
        loop = []
        for addr, op in ins:
            m = re.search(r"\bBRA (0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr:
                body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr]
                loop = max(loop, body, key=len)
        print(f"{fn}: {len(ins)} instructions; longest loop {len(loop)} "
              f"(MUFU {sum('MUFU' in o for o in loop)}, IMAD.WIDE "
              f"{sum('IMAD.WIDE' in o for o in loop)}, branches "
              f"{sum('BRA' in o for o in loop)})")


def ptxas(name: str) -> None:
    import importlib.util

    from nbest_asr_tpu_torch.ops import _cuda

    if _cuda.library_path().exists():
        raise RuntimeError(f"{_cuda.library_path()} exists: ptxas reports "
                           "only on a fresh build")
    _cuda.build()
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for line in smoke.ptxas_summary(_cuda.build_report):
        if name in line:
            print(line)


def gelu_dump(out: str) -> None:
    from nbest_asr_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(5)
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        for m, n in ((8192, 3072), (193, 3076)):
            x = (torch.randn(m, n, generator=g) * 3).to(dt)
            x.view(-1)[:len(SPECIAL)] = torch.tensor(SPECIAL).to(dt)
            b = torch.randn(n, generator=g)
            b[:len(SPECIAL)] = 0
            dy = torch.randn(m, n, generator=g).to(dt)
            x, b, dy = x.to(dev), b.to(dev), dy.to(dev)
            res[f"fwd {dt} {m} x {n}"] = K.bias_gelu(x, b).cpu()
            res[f"bwd {dt} {m} x {n}"] = K.bias_gelu_bwd(x, b, dy).cpu()
    every = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).reshape(64, 1024).to(dev)
    for tag, b in (("bias 0", torch.zeros(1024)),
                   ("bias random", torch.randn(1024, generator=g))):
        b, dy = b.to(dev), torch.ones_like(every)
        res[f"every bf16 fwd, {tag}"] = K.bias_gelu(every, b).cpu()
        res[f"every bf16 bwd, {tag}"] = K.bias_gelu_bwd(every, b, dy).cpu()
        res[f"every bf16 as f32 bwd, {tag}"] = K.bias_gelu_bwd(
            every.float(), b, dy.float()).cpu()
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (4096, 1024), generator=g,
                         dtype=torch.int64).to(torch.int32)
    x, b0 = bits.view(torch.float32).to(dev), torch.zeros(1024, device=dev)
    res["f32 bit patterns fwd"] = K.bias_gelu(x, b0).cpu()
    res["f32 bit patterns bwd"] = K.bias_gelu_bwd(x, b0,
                                                  torch.ones_like(x)).cpu()
    torch.save(res, out)
    print(f"{len(res)} cases -> {out}")


# attn-dump's cases: (head dim, heads, batch, seq, layout)
ATTN_CASES = ([(64, 12, 4, s, "qkv") for s in (64, 96, 130, 160, 256, 300,
                                               512)]
              + [(64, 12, 4, s, "bshd") for s in (160, 256)]
              + [(96, 8, 4, s, "qkv") for s in (64, 96, 160, 256, 300,
                                                512)]
              + [(96, 8, 4, 256, "bshd"), (192, 4, 4, 256, "qkv"),
                 (184, 4, 4, 300, "qkv")]
              + [(32, 8, 4, 160, "bshd"), (80, 8, 4, 160, "qkv"),
                 (128, 6, 4, 256, "qkv"), (136, 4, 4, 256, "qkv")])


# attn-dump's tiled cases: (head dim, heads, batch, seq)
TILED_CASES = [(d, 4, 2, s) for d in (64, 96) for s in (700, 1024)] + [
    (d, 4, 2, 700) for d in (32, 128, 192, 256, 48, 80)]

# attn-dump's chunked cases (the chunked family's head dims: d > 256 or d %
# 8 != 0): (head dim, heads, batch, seq); single-block to 512, tiled past
CHUNKED_CASES = [(d, nh, 2, s) for d, nh in ((12, 8), (258, 2), (384, 2))
                 for s in (77, 256, 700)]


def _held(got, want) -> bool:
    """The card tests' tolerance for an attention output (two bf16 ulps
    of the largest value at most, 1e-3 on average)."""
    diff = (got.float() - want.float()).abs()
    return (diff.max().item() <= 2.0 ** -6 * want.float().abs().max().item()
            and diff.mean().item() <= 1e-3)


def attn_dump(out: str) -> None:
    from nbest_asr_tpu_torch.ops import kernels as K
    from nbest_asr_tpu_torch.ops.philox import site

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(6)
    res = {}
    for d, nh, b, s, layout in ATTN_CASES:
        h = nh * d
        qkv = (torch.randn(b * s, 3 * h, generator=g) * 0.5).to(
            dev, torch.bfloat16)
        dctx = (torch.randn(b * s, h, generator=g) * 0.1).to(
            dev, torch.bfloat16)
        mask = torch.ones(b, s)
        mask[:, s // 3: 2 * s // 3], mask[0, s - s // 4:] = 2.0, 0.0
        mask = mask.to(dev)
        for rate in (0.0, 0.1):
            tag = f"d {d} x {nh} {b} x {s} {layout} rate {rate}"
            drop = site(77, rate, 3) if rate else None
            if layout == "qkv":
                ctx, st = K.seg_attention(qkv, mask, nh, drop=drop,
                                          stats=True)
                grads = (K.seg_attention_bwd(qkv, dctx, mask, st, nh,
                                             drop=drop),)
            else:
                q, k, v = (t.contiguous() for t in
                           qkv.view(b, s, 3, nh, d).unbind(2))
                sc = d ** -0.5
                ctx, st = K.sb_attention(q, k, v, mask, sc, drop, True)
                grads = K.sb_attention_bwd(q, k, v, dctx.view(b, s, nh, d),
                                           mask, st, sc, drop)
            res[f"fwd {tag}"] = ctx.cpu()
            res[f"stats {tag}"] = st.cpu()
            for i, gr in enumerate(grads):
                res[f"bwd {tag} {i}"] = gr.cpu()
    for d, nh, b, s in TILED_CASES:
        h = nh * d
        q, k, v = (torch.randn(b * s, 3 * h, generator=g) * 0.5).to(
            dev, torch.bfloat16).view(b, s, 3, nh, d).unbind(2)
        do = (torch.randn(b, s, nh, d, generator=g) * 0.1).to(
            dev, torch.bfloat16)
        mask = torch.ones(b, s)
        mask[:, s // 3: 2 * s // 3], mask[0, s - s // 4:] = 2.0, 0.0
        mask = mask.to(dev)
        sc = d ** -0.5
        for rate in (0.0, 0.1):
            tag = f"tiled d {d} x {nh} {b} x {s} rate {rate}"
            drop = site(78, rate, 3) if rate else None
            o, lse = K.flash_fwd(q, k, v, mask, sc, drop)
            dq, di = K.flash_bwd_dq(q, k, v, mask, o, lse, do, sc, drop)
            dk, dv = K.flash_bwd_dkv(q, k, v, mask, lse, di, do, sc, drop)
            for name, t in zip(("o", "lse", "dq", "di", "dk", "dv"),
                               (o, lse, dq, di, dk, dv)):
                res[f"{name} {tag}"] = t.cpu()
            # the backward pair on the plain forward's o and lse: the same
            # inputs whichever forward kernel the checkout has
            o, lse = K.flash_fwd_reference(q, k, v, mask, sc, drop)
            dq, di = K.flash_bwd_dq(q, k, v, mask, o, lse, do, sc, drop)
            dk, dv = K.flash_bwd_dkv(q, k, v, mask, lse, di, do, sc, drop)
            for name, t in zip(("dq", "di", "dk", "dv"), (dq, di, dk, dv)):
                res[f"{name} {tag} on the plain forward"] = t.cpu()
    for d, nh, b, s in CHUNKED_CASES:
        # chunked_fwd held to its plain version by tolerance (its bits are
        # a design's own); the backward pair fed the plain forward's
        # statistics, bit for bit
        q, k, v = (torch.randn(b * s, 3 * nh * d, generator=g) * 0.5).to(
            dev, torch.bfloat16).view(b, s, 3, nh, d).unbind(2)
        do = (torch.randn(b, s, nh, d, generator=g) * 0.1).to(
            dev, torch.bfloat16)
        mask = torch.ones(b, s)
        mask[:, s // 3: 2 * s // 3], mask[0, s - s // 4:] = 2.0, 0.0
        mask = mask.to(dev)
        sc = d ** -0.5
        for rate in (0.0, 0.1):
            tag = f"chunked d {d} x {nh} {b} x {s} rate {rate}"
            drop = site(79, rate, 3) if rate else None
            if s <= K.MAX_SEQ:
                o, st = K.sb_attention(q, k, v, mask, sc, drop, True)
                ro, rst = K.sb_attention_reference(q, k, v, mask, sc, drop,
                                                   True)
                held = _held(o, ro) and torch.allclose(st, rst, rtol=1e-5,
                                                       atol=1e-6)
                grads = K.sb_attention_bwd(q, k, v, do, mask, rst, sc, drop)
                names = ("dq", "dk", "dv")
            else:
                o, lse = K.flash_fwd(q, k, v, mask, sc, drop)
                ro, rlse = K.flash_fwd_reference(q, k, v, mask, sc, drop)
                held = _held(o, ro) and torch.allclose(lse, rlse, rtol=1e-5,
                                                       atol=1e-5)
                dq, di = K.flash_bwd_dq(q, k, v, mask, ro, rlse, do, sc, drop)
                grads = (dq, di, *K.flash_bwd_dkv(q, k, v, mask, rlse, di, do,
                                                  sc, drop))
                names = ("dq", "di", "dk", "dv")
            print(f"chunked_fwd {tag}: {'held' if held else 'NOT held'} to "
                  "its plain version")
            res[f"chunked_fwd held to the plain version {tag}"] = (
                torch.tensor(held))
            for name, t in zip(names, grads):
                res[f"{name} {tag} on the plain forward"] = t.cpu()
    torch.save(res, out)
    print(f"{len(res)} cases -> {out}")


def chunked_variants(sources) -> None:
    import ctypes
    import json
    import tempfile

    from chip_time_attention import CHUNKED_SHAPES, H
    from nbest_asr_tpu_torch.ops import _cuda
    from nbest_asr_tpu_torch.ops import kernels as K
    from nbest_asr_tpu_torch.ops.kernels import _drop_args
    from nbest_asr_tpu_torch.ops.philox import site

    out_dir = tempfile.mkdtemp(prefix="chunked_variants_")
    libs = [os.path.join(out_dir, f"v{i}.so") for i in range(len(sources))]
    procs = [subprocess.Popen(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", str(_cuda.CSRC),
         "-o", so, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for so, src in zip(libs, sources)]
    for src, pr in zip(sources, procs):
        log = pr.communicate()[0]
        if pr.returncode:
            raise RuntimeError(f"nvcc {src}:\n{log[-4000:]}")
        spills = re.findall(r"([1-9]\d*) bytes spill stores", log)
        print(f"{src}: {log.count('Performance Loss')} wgmma notes, spill "
              f"stores {spills} B")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = []
    for so in libs:
        lib = ctypes.CDLL(so)
        lib.nbk_chunked_fwd.argtypes = [p, p, p, i, p, p, p, p] + [i] * 5 + [
            f, ctypes.c_uint64, i, ctypes.c_uint32, f, i, p]
        fns.append(lib)
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    for b, s, nh, d in CHUNKED_SHAPES:
        q, k, v = (torch.randn(b * s, 3 * H, generator=g) * 0.5).to(
            dev, torch.bfloat16).view(b, s, 3, nh, d).unbind(2)
        lengths = torch.randint(3 * s // 4, s + 1, (b, 1), generator=g)
        mask = (torch.arange(s)[None] < lengths).float().to(dev)
        o = torch.empty(b, s, nh, d, dtype=torch.bfloat16, device=dev)
        st = torch.empty(2, b, nh, s, device=dev)
        tiled, sc = s > K.MAX_SEQ, d ** -0.5
        for rate in (0.1, 0.0):
            drop = site(1, rate, 3) if rate else None
            stream = torch.cuda.current_stream().cuda_stream

            def call(lib):
                _cuda.check(lib.nbk_chunked_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), 3 * H,
                    mask.data_ptr(), o.data_ptr(), st.data_ptr(),
                    None if tiled else st.data_ptr() + 4 * b * nh * s,
                    int(tiled), b, s, nh, d, sc, *_drop_args(drop), stream),
                    "chunked_fwd")

            want = (K.flash_fwd_reference if tiled else
                    K.sb_attention_reference)(q, k, v, mask, sc, drop)
            want = want[0] if isinstance(want, tuple) else want
            row = {src: {"ms": []} for src in sources}
            order = ([0, 1, 1, 0] if len(fns) == 2
                     else list(range(len(fns))) * 2)
            for j in order:
                row[sources[j]]["ms"].append(round(
                    _device_ms(lambda: call(fns[j])), 4))
            for src, lib in zip(sources, fns):
                if hasattr(lib, "nbk_prof_read"):
                    sums = (ctypes.c_ulonglong * 8)()
                    lib.nbk_prof_read(sums)
                call(lib)
                torch.cuda.synchronize()
                row[src]["max_abs_err"] = round(
                    (o.float() - want.float()).abs().max().item(), 5)
                if hasattr(lib, "nbk_prof_read"):
                    lib.nbk_prof_read(sums)
                    blocks = b * nh * -(-s // 64)
                    row[src]["clocks_per_block"] = [
                        round(x / blocks) for x in sums]
            print(json.dumps({"shape": f"{b}x{s}x{nh}x{d}", "rate": rate,
                              "variants": row}), flush=True)
        del q, k, v, o, st


def _device_ms(fn, iters: int = 20) -> float:
    """Per-call device time of fn, queued behind a sleep (as
    chip_time_attention.device_ms)."""
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


def compare(a_path: str, b_path: str) -> int:
    def bits(t):
        return t.view({torch.bfloat16: torch.int16,
                       torch.float32: torch.int32}.get(t.dtype, t.dtype))

    a, b = torch.load(a_path), torch.load(b_path)
    differ = [k for k in a if k not in b
              or not torch.equal(bits(a[k]), bits(b[k]))]
    print(f"{a_path} vs {b_path}: {len(a)} cases, {len(differ)} differ in "
          f"a bit: {differ}")
    return 1 if differ else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("what", choices=("sass", "ptxas", "gelu-dump",
                                     "attn-dump", "compare",
                                     "chunked-variants"))
    ap.add_argument("args", nargs="+")
    args = ap.parse_args()
    if args.what == "compare":
        return compare(*args.args)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script probes the "
                           "port's kernels on an NVIDIA GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    if args.what == "sass":
        sass(args.args[0])
    elif args.what == "ptxas":
        ptxas(args.args[0])
    elif args.what == "attn-dump":
        attn_dump(args.args[0])
    elif args.what == "chunked-variants":
        chunked_variants(args.args)
    else:
        gelu_dump(args.args[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
