"""Quality smoke: full-pipeline training to convergence on the DSTC2
``valid`` shard -- the port of ``tools/quality_smoke.py``, with its flags,
its split, its CLI arguments and its last line.

Splits the shard under ``REF_RAW`` 80/10/10 into train / valid / test,
converts ``memory.pt`` to ``memory.json``, trains a from-scratch encoder
through the port's CLI (``cli.main``, on the card) and prints the run's
``best.json`` as its last line.  Writes ``QUALITY.md`` (or ``--md_out``)
with the curve's best numbers and the card's name and power limit.  This
is not the paper's benchmark (that needs pretrained bert-base-uncased and
the full DSTC2 train set); it shows that the training path converges end
to end.

Run: python -m nbest_asr_tpu_torch.tools.quality_smoke [--epochs N]
         [--out exp_dir] [--platform cpu]
Returns 2 when the shard is missing; runs on the card unless ``--platform
cpu`` and raises without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .pretrain_mlm import resolve_device

REF_RAW = "/root/reference/dstc2_data/processed_data/raw"


def write_split_dataroot(ref_raw: str, out: str) -> str:
    """``<out>/dataroot`` with ``ref_raw``'s ``valid`` shard split
    80/10/10 into train / valid / test and ``memory.json`` converted from
    its ``memory.pt`` (``tools/quality_smoke.py:66-85``)."""
    from ..data.vocab import Memory

    dataroot = os.path.join(out, "dataroot")
    os.makedirs(dataroot, exist_ok=True)
    with open(os.path.join(ref_raw, "valid")) as fp:
        lines = fp.readlines()
    n = len(lines)
    cut1, cut2 = int(n * 0.8), int(n * 0.9)
    for name, chunk in (("train", lines[:cut1]),
                        ("valid", lines[cut1:cut2]),
                        ("test", lines[cut2:])):
        with open(os.path.join(dataroot, name), "w") as fp:
            fp.writelines(chunk)
    Memory.from_torch_pt(os.path.join(ref_raw, "memory.pt")).save(
        os.path.join(dataroot, "memory.json"))
    return dataroot


def device_text(dev) -> str:
    """The device a run used, for a report: the card's ``nvidia-smi``
    name and power limit, or "the CPU"."""
    if dev.type != "cuda":
        return "the CPU"
    from .gpu_kernel_check import card_line

    return card_line()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--out", default="/tmp/quality_smoke")
    ap.add_argument("--n_layers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--token_budget", type=int, default=None)
    ap.add_argument("--seed", type=int, default=999)
    ap.add_argument("--md_out", default=None,
                    help="write the markdown summary here (default: "
                    "<out>/QUALITY.md)")
    ap.add_argument("--coverage", type=float, default=None,
                    help="pass --coverage to the CLI (the reference's "
                    "sample-complexity protocol, README.md:64)")
    ap.add_argument("--eval_every", type=int, default=1,
                    help="pass --eval_every to the CLI (coverage sweeps "
                    "use epochs~1/c with eval_every~1/c for a "
                    "constant-step, constant-eval-count protocol)")
    ap.add_argument("--extra", default="",
                    help="extra CLI args, space-separated (e.g. "
                    "'--no_fused_ffn --no_fused_attn')")
    ap.add_argument("--platform", default=None,
                    help="'cpu' trains on the CPU (the tests); anything "
                    "else, or nothing, on the card")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.platform, "quality_smoke")
    if not os.path.exists(os.path.join(REF_RAW, "valid")):
        print("reference valid shard unavailable", file=sys.stderr)
        return 2

    os.makedirs(args.out, exist_ok=True)
    dataroot = write_split_dataroot(REF_RAW, args.out)

    from ..cli import main as cli_main

    t0 = time.time()
    rc = cli_main([
        "--dataset", "dstc2_smoke", "--dataroot", dataroot,
        "--n_layers", str(args.n_layers), "--n_head", "8",
        "--optim_choice", "bertadam",
        "--lr", str(args.lr), "--bert_lr", str(args.lr),
        "--warmup_proportion", "0.1",
        "--dropout", "0.1", "--bert_dropout", "0.1",
        "--batchSize", "32", "--max_epoch", str(args.epochs),
        "--random_seed", str(args.seed),
        "--compute_dtype", "bfloat16",
        "--length_buckets", "96,160,256",
        "--add_segment_ids",
        # sweep runs only read best.json: no per-epoch dumps and no
        # best-checkpoint writes (the metrics are the same)
        "--eval_artifacts", "none", "--save_best", "none",
        "--experiment", os.path.join(args.out, "exp"),
    ] + (["--token_budget", str(args.token_budget)]
         if args.token_budget else [])
      + (["--coverage", str(args.coverage)]
         if args.coverage is not None else [])
      + (["--eval_every", str(args.eval_every)]
         if args.eval_every != 1 else [])
      + (args.extra.split() if args.extra else []), device=dev)
    wall = time.time() - t0
    if rc != 0:
        return rc

    best = None
    for dirpath, _, files in os.walk(os.path.join(args.out, "exp")):
        if "best.json" in files:
            with open(os.path.join(dirpath, "best.json")) as fp:
                best = json.load(fp)
    if best is None:
        print(f"no best.json under {os.path.join(args.out, 'exp')}",
              file=sys.stderr)
        return 1

    md = args.md_out or os.path.join(args.out, "QUALITY.md")
    with open(md, "w") as fp:
        fp.write(
            "# Quality smoke (from-scratch, valid-shard 80/10/10)\n\n"
            "Full pipeline (ETL artifacts -> packer -> CLI trainer -> "
            "decode -> string-exact F1) on the DSTC2 valid shard.  "
            "From-scratch word-vocab encoder -- NOT comparable to the "
            "paper's pretrained-BERT 87.4 F1; demonstrates the training "
            "path converges end to end.\n\n"
            f"- encoder: {args.n_layers}L/768H from scratch, bf16, "
            f"buckets 96/160/256, batch 32, bertadam lr {args.lr}\n"
            f"- epochs: {args.epochs}, wall: {wall:.0f}s on "
            f"{device_text(dev)} (incl. the kernels' first use)\n\n"
            f"| metric | value |\n|---|---|\n"
            f"| best valid F1 | {best['vf']:.2f} |\n"
            f"| best valid Acc | {best['v_acc']:.2f} |\n"
            f"| test F1 @ best valid | {best['tef']:.2f} |\n"
            f"| test Acc @ best valid | {best['te_acc']:.2f} |\n"
            f"| best epoch | {best['epoch']} |\n")
    print(json.dumps(best))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
