"""Aggregate a quality_sweep results.jsonl into the QUALITY.md tables --
a copy of ``tools/quality_aggregate.py`` (``mean_std``, ``fmt``,
``welch_t`` and ``main``), whose output it reproduces byte for byte.

Reads the per-run JSON lines ``nbest_asr_tpu_torch.tools.quality_sweep``
appends (fields from quality_smoke's best.json: vf/v_acc/tef/te_acc/epoch
plus seed/extra/coverage/wall_s/rc) and prints:

1. the 10-seed two-arm table (flash-only vs shipping defaults,
   mean ± std for valid/test F1/Acc) with a Welch t-statistic on test
   F1 -- the quality-neutrality protocol;
2. the reference coverage-sweep table (c ∈ {0.05, 0.10, 0.20, 0.50},
   ref `README.md:64`), mean ± std over its seeds.

Host only: it reads a log and touches no device.

Usage: python -m nbest_asr_tpu_torch.tools.quality_aggregate
           [--log /tmp/qsweep/results.jsonl]
"""

from __future__ import annotations

import argparse
import json
import math
from collections import defaultdict


def mean_std(xs):
    n = len(xs)
    m = sum(xs) / n
    if n < 2:
        return m, 0.0
    var = sum((x - m) ** 2 for x in xs) / (n - 1)
    return m, math.sqrt(var)


def fmt(xs):
    m, s = mean_std(xs)
    return f"{m:.2f} ± {s:.2f}"


def welch_t(a, b):
    ma, sa = mean_std(a)
    mb, sb = mean_std(b)
    va, vb = sa * sa / len(a), sb * sb / len(b)
    denom = math.sqrt(va + vb)
    if denom == 0:
        return 0.0, 0.0
    t = (ma - mb) / denom
    if len(a) < 2 or len(b) < 2:
        # A 1-run arm has no variance estimate: the t value is still
        # reportable but the Welch–Satterthwaite dof is undefined.
        return t, float("nan")
    # Welch–Satterthwaite dof
    dof = (va + vb) ** 2 / (va ** 2 / (len(a) - 1) + vb ** 2 / (len(b) - 1))
    return t, dof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", default="/tmp/qsweep/results.jsonl")
    ap.add_argument("--arm", action="append", default=[],
                    metavar="NAME=EXTRA",
                    help="register an extra arm (e.g. "
                    "'pretrained=--tod_pre_trained_model /x "
                    "--require_pretrained'); repeatable")
    ap.add_argument("--cov_extra", default=None,
                    help="coverage rows must carry exactly this extra "
                    "string (default: accept any)")
    args = ap.parse_args(argv)

    # Known arm --extra strings (mirror of quality_sweep.ARMS): runs
    # logged with any other ad-hoc flags are skipped with a warning
    # instead of being silently counted into an arm.
    known_extras = {"": "shipping", "--no_fused_ffn --no_fused_attn": "flash_only"}
    for spec in args.arm:
        name, _, extra = spec.partition("=")
        known_extras[extra] = name

    arms = defaultdict(lambda: defaultdict(list))   # arm -> metric -> []
    cov = defaultdict(lambda: defaultdict(list))    # coverage -> metric -> []
    n_fail = 0
    with open(args.log) as fp:
        for line in fp:
            r = json.loads(line)
            if r.get("rc") != 0:
                n_fail += 1
                continue
            tgt = None
            if r.get("coverage") is not None:
                if args.cov_extra is not None and \
                        r.get("extra", "") != args.cov_extra:
                    continue
                tgt = cov[float(r["coverage"])]
            else:
                arm = known_extras.get(r.get("extra", ""))
                if arm is None:
                    print(f"WARNING: skipping run with unknown extra "
                          f"{r.get('extra')!r} (seed {r.get('seed')})")
                    continue
                tgt = arms[arm]
            for k in ("vf", "v_acc", "tef", "te_acc"):
                tgt[k].append(float(r[k]))
            tgt["epoch"].append(int(r["epoch"]))
            tgt["wall_s"].append(float(r["wall_s"]))
    if n_fail:
        print(f"WARNING: {n_fail} failed runs excluded\n")

    if arms:
        print("## arm protocol (seeds x n)\n")
        print("| arm | n | valid F1 | valid Acc | test F1 | test Acc |")
        print("|---|---|---|---|---|---|")
        for name in sorted(arms):
            a = arms.get(name)
            if not a:
                continue
            print(f"| {name} | {len(a['tef'])} | {fmt(a['vf'])} | "
                  f"{fmt(a['v_acc'])} | {fmt(a['tef'])} | "
                  f"{fmt(a['te_acc'])} |")
        if len(arms) == 2:
            na, nb = sorted(arms)
            t, dof = welch_t(arms[na]["tef"], arms[nb]["tef"])
            print(f"\ntest-F1 Welch t ({na} - {nb}): "
                  f"t={t:.2f}, dof={dof:.1f}")

    if cov:
        print("\n## coverage sweep (reference protocol, README.md:64)\n")
        print("| coverage | n seeds | valid F1 | test F1 | test Acc | "
              "per-seed test F1 | converged (>=70) |")
        print("|---|---|---|---|---|---|---|")
        for c in sorted(cov):
            a = cov[c]
            per_seed = " / ".join(f"{x:.1f}" for x in sorted(a["tef"]))
            n_conv = sum(x >= 70.0 for x in a["tef"])
            print(f"| {c:.2f} | {len(a['tef'])} | {fmt(a['vf'])} | "
                  f"{fmt(a['tef'])} | {fmt(a['te_acc'])} | {per_seed} | "
                  f"{n_conv}/{len(a['tef'])} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
