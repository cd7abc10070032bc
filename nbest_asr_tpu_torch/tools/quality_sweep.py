"""The quality measurement protocol -- the port of ``tools/quality_sweep.py``,
with its flags, its arms, its per-run command lines (``python -m
nbest_asr_tpu_torch.tools.quality_smoke`` in place of
``tools/quality_smoke.py``) and its log lines.

Two claims need real statistics:

1. **Shipping-default quality neutrality at n=10.**  Seeds 999..1008 for
   both arms: flash-only (``--no_fused_ffn --no_fused_attn``) and the
   shipping defaults (the attention and FFN kernels, flash).
2. **The reference's sample-complexity (coverage) protocol** -- c in
   {0.05, 0.10, 0.20, 0.50} (ref ``README.md:64``,
   ``run/train_eval_N_Best_ASR_Transformer_STC.sh:46-52``), 3 seeds a
   point on the stratified subset.

Each run is a full from-scratch CLI training on the smoke split through
``quality_smoke``, one subprocess per run (one process on the card at a
time).  Appends one JSON line per run to ``--log`` as it goes, so a
partial sweep is still usable evidence; a rerun skips the runs the log
holds.  The runs train on the card; ``--platform cpu`` passes
``--platform cpu`` to each, and without it the sweep refuses to start
when there is no CUDA.

Run: python -m nbest_asr_tpu_torch.tools.quality_sweep
         --log /tmp/qsweep/results.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from .pretrain_mlm import resolve_device

# the command that runs one quality_smoke (its flags follow)
SMOKE = [sys.executable, "-m", "nbest_asr_tpu_torch.tools.quality_smoke"]

ARMS = {
    "flash_only": "--no_fused_ffn --no_fused_attn",
    "shipping": "",
}


def run_one(out_dir, seed, extra, coverage, epochs, log_path, lr=None,
            platform=None):
    n_epochs = epochs
    cmd = [*SMOKE,
           "--token_budget", "8192",
           "--seed", str(seed), "--out", out_dir]
    if lr:
        cmd += ["--lr", str(lr)]
    if extra:
        cmd += ["--extra", extra]
    if coverage is not None:
        # constant-STEP budget across coverage points: a c-fraction
        # train split gets ~1/c more epochs (and evals every ~1/c
        # epochs, so every point sees the same ~`epochs` eval points).
        # With fixed epochs a from-scratch low-coverage run gets
        # proportionally fewer optimizer steps and the curve measures
        # step count, not sample complexity (measured at 40 fixed
        # epochs: c=0.1 scored test F1 8.5 ± 4.5, non-monotonic in c).
        # The paper's fixed-epoch protocol doesn't hit this because it
        # starts from pretrained bert-base.
        scale = max(1, round(1.0 / coverage))
        n_epochs = epochs * scale
        cmd += ["--coverage", str(coverage),
                "--eval_every", str(scale)]
    cmd += ["--epochs", str(n_epochs)]
    if platform:
        cmd += ["--platform", platform]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.time() - t0
    rec = {"seed": seed, "extra": extra, "coverage": coverage,
           "wall_s": round(wall, 1), "rc": proc.returncode}
    if proc.returncode == 0:
        # best.json dict is the last stdout line
        rec.update(json.loads(proc.stdout.strip().splitlines()[-1]))
    else:
        rec["stderr_tail"] = proc.stderr[-800:]
    with open(log_path, "a") as fp:
        fp.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)
    return proc.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", default="/tmp/qsweep/results.jsonl")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--seeds", default="999-1008")
    ap.add_argument("--cov_seeds", default="999-1001")
    ap.add_argument("--skip_arms", action="store_true")
    ap.add_argument("--skip_coverage", action="store_true")
    ap.add_argument("--pretrained", default=None,
                    help="run the protocol FROM a pretrained init "
                    "(a pretrain_mlm checkpoint dir): replaces "
                    "the two from-scratch arms with one pretrained arm "
                    "and adds the init flags to every coverage run "
                    "(the de-lotteried protocol)")
    ap.add_argument("--lr", default=None,
                    help="override quality_smoke's lr (pretrained "
                    "fine-tuning wants a smaller one than from-scratch)")
    ap.add_argument("--arm_extra", default=None,
                    help="replace the arm table with one arm running "
                    "these extra CLI flags (e.g. '--int8_train'); "
                    "arm-only — coverage runs do NOT get these")
    ap.add_argument("--base_extra", default=None,
                    help="extra CLI flags appended to EVERY run, arms "
                    "and coverage alike (e.g. '--n_layers 12' for the "
                    "headline-geometry protocol)")
    ap.add_argument("--arms", default=None,
                    help="comma-separated subset of the arm table to "
                    "run (default: all arms)")
    ap.add_argument("--platform", default=None,
                    help="'cpu' trains every run on the CPU (the tests); "
                    "anything else, or nothing, on the card")
    args = ap.parse_args(argv)
    resolve_device(args.platform, "quality_sweep")

    global ARMS
    init = None
    if args.pretrained:
        init = ("--tod_pre_trained_model %s "
                "--require_pretrained" % args.pretrained)
        # --arm_extra composes: one arm fine-tuning FROM the pretrained
        # init WITH the extra flags (e.g. the int8-train interaction arm)
        if args.arm_extra is not None:
            ARMS = {"pretrained+custom": init + " " + args.arm_extra}
        else:
            ARMS = {"pretrained": init}
    elif args.arm_extra is not None:
        ARMS = {"custom": args.arm_extra}
    if args.arms:
        keep = set(args.arms.split(","))
        unknown = keep - set(ARMS)
        if unknown:
            ap.error(f"--arms {sorted(unknown)} not in arm table "
                     f"{sorted(ARMS)}")
        ARMS = {k: v for k, v in ARMS.items() if k in keep}

    def with_base(extra):
        if not args.base_extra:
            return extra
        return (extra + " " + args.base_extra).strip()

    os.makedirs(os.path.dirname(args.log), exist_ok=True)

    def parse_range(s):
        a, b = s.split("-")
        return range(int(a), int(b) + 1)

    done = set()
    if os.path.exists(args.log):   # resumable
        with open(args.log) as fp:
            for line in fp:
                r = json.loads(line)
                if r.get("rc") == 0:
                    done.add((r["seed"], r["extra"],
                              r.get("coverage")))

    work = []
    if not args.skip_arms:
        for name, extra in ARMS.items():
            for seed in parse_range(args.seeds):
                work.append((seed, with_base(extra), None, name))
    if not args.skip_coverage:
        # under --pretrained the coverage runs fine-tune FROM the
        # pretrained init too (the de-lotteried sample-complexity
        # protocol); from-scratch otherwise.  Coverage stays PURE init
        # (+ base_extra): --arm_extra flags are arm-only, so an
        # interaction sweep doesn't silently change the coverage
        # protocol.
        cov_extra = with_base(init if args.pretrained else "")
        cov_name = "pretrained" if args.pretrained else "scratch"
        for cov in (0.05, 0.10, 0.20, 0.50):
            for seed in parse_range(args.cov_seeds):
                work.append((seed, cov_extra, cov, cov_name))

    for i, (seed, extra, cov, name) in enumerate(work):
        if (seed, extra, cov) in done:
            print(f"[{i+1}/{len(work)}] skip (done)", flush=True)
            continue
        # out_dir tag derives from the ARM NAME (inferring
        # 'ship'/'flash' from extra truthiness made distinct arms share
        # per-run dirs and overwrite artifacts)
        tag = f"s{seed}_{name}" + (f"_c{cov}" if cov is not None else "")
        out_dir = os.path.join(os.path.dirname(args.log), tag)
        print(f"[{i+1}/{len(work)}] {tag}", flush=True)
        run_one(out_dir, seed, extra, cov, args.epochs, args.log,
                lr=args.lr, platform=args.platform)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
