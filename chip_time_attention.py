#!/usr/bin/env python3
"""Time the port's attention kernels of one checkout on one NVIDIA GPU,
so that two commits can be compared on the same card:

    python3 chip_time_attention.py [--root CHECKOUT] [--iters N]

``--root`` is the root of a checkout of this repository (default: the
directory of this script); its ``nbest_asr_tpu_torch`` is imported and
its kernels are built into its own ``build/``.  BERT-base widths (hidden
768, 12 heads), bf16, a padded mask from a fixed seed.  Prints one JSON
line: ``seg_attention`` ms per call at batch 64 x seq {64, 96, 160, 256}
(the serving forward), and, where the checkout has the training kernels,
``seg_attention`` with prob dropout and row statistics and
``seg_attention_bwd`` at 8192 rows (32 x 256), with the card's name and
power limit.  CUDA events over ``--iters`` calls after two warm-up calls.
Run two checkouts alternately (A B B A) in one call to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

H, NH = 768, 12


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script times the "
                           "port's kernels on an NVIDIA GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    from nbest_asr_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    out = {"root": args.root, "serving_ms": {}}
    for b, s in ((64, 64), (64, 96), (64, 160), (64, 256)):
        qkv = (torch.randn(b * s, 3 * H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        mask = (torch.rand(b, s, generator=gen) > 0.2).float().to(dev)
        out["serving_ms"][s] = cuda_ms(lambda: K.seg_attention(qkv, mask, NH),
                                       args.iters)
    if hasattr(K, "seg_attention_bwd"):
        from nbest_asr_tpu_torch.ops.philox import site

        b, s = 32, 256
        qkv = (torch.randn(b * s, 3 * H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        dctx = (torch.randn(b * s, H, generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        mask = (torch.rand(b, s, generator=gen) > 0.2).float().to(dev)
        drop = site(1, 0.1, 3)
        _, st = K.seg_attention(qkv, mask, NH, drop=drop, stats=True)
        out["train_fwd_ms"] = cuda_ms(
            lambda: K.seg_attention(qkv, mask, NH, drop=drop, stats=True),
            args.iters)
        out["train_bwd_ms"] = cuda_ms(
            lambda: K.seg_attention_bwd(qkv, dctx, mask, st, NH, drop=drop),
            args.iters)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
