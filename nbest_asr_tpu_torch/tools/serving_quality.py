"""Serving-numerics quality gate -- the port of ``tools/serving_quality.py``,
with its flags, its training run, its ``serving_quality.json`` keys
(``on_gpu`` in place of ``on_tpu``) and its markdown table.

``Predictor(quantize="int8")`` and the attention kernels on the
deterministic forward both change numerics.  From one trained checkpoint
this tool evaluates the valid and test shards through

  (a) ``bf16_xla``: bf16, every kernel flag off (the plain path: the
      quality contract's numerics),
  (b) ``fused_attn_eval``: the attention kernels on the forward (the
      serving default on the card; card only),
  (c) ``int8``: ``quantize="int8"`` (on the card its chains run on the
      int8 kernels; on the CPU their plain versions),

and reports F1 / Acc / agreement with (a) per arm.  The shards are the
80/10/10 split of REF_RAW's ``valid`` shard that ``quality_smoke`` makes;
the training run is ``cli.main`` with JAX's argument list (or the run
under ``<out>/exp`` again with ``--reuse``); the model config is rebuilt
from the run's ``config.json`` as the CLI built it.

Run (card):
  python -m nbest_asr_tpu_torch.tools.serving_quality --out D  # trains
  python -m nbest_asr_tpu_torch.tools.serving_quality --out D --reuse
``--platform cpu`` runs on the CPU (the tests); without CUDA otherwise it
raises.  Returns 2 when the shard is missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time

from . import quality_smoke
from .pretrain_mlm import resolve_device

REF_RAW = "/root/reference/dstc2_data/processed_data/raw"


def tuple_f1_acc(preds, golds):
    """String-exact tuple micro-F1 + utterance exact accuracy
    (`utils/fscore.py:2-21` semantics); a copy of
    ``tools/serving_quality.py:tuple_f1_acc``."""
    tp = fp = fn = correct = 0
    for p, g in zip(preds, golds):
        ps, gs = set(p), set(g)
        tp += len(ps & gs)
        fp += len(ps - gs)
        fn += len(gs - ps)
        correct += ps == gs
    prec = 100.0 * tp / max(tp + fp, 1)
    rec = 100.0 * tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return f1, 100.0 * correct / max(len(preds), 1)


def agreement(preds_a, preds_b) -> float:
    """Percent of utterances whose label sets agree; a copy of
    ``tools/serving_quality.py:agreement``."""
    same = sum(set(a) == set(b) for a, b in zip(preds_a, preds_b))
    return 100.0 * same / max(len(preds_a), 1)


# arms served with every kernel flag of the config off
PLAIN_ARMS = ("bf16_xla",)


def build_arms(on_gpu: bool):
    """Arm name -> Predictor kwargs (``tools/serving_quality.py:
    build_arms``); the arms in ``PLAIN_ARMS`` also turn the config's
    kernel flags off."""
    arms = {"bf16_xla": dict(quantize="none", fused_attn_eval=False),
            "int8": dict(quantize="int8", fused_attn_eval=bool(on_gpu))}
    if on_gpu:
        arms["fused_attn_eval"] = dict(quantize="none",
                                       fused_attn_eval=True)
    return arms


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/serving_quality")
    ap.add_argument("--reuse", action="store_true",
                    help="reuse <out>/exp/**/model.ckpt instead of "
                    "training")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--seed", type=int, default=999)
    ap.add_argument("--extra", default="",
                    help="extra CLI args for the training run (e.g. "
                    "'--tod_pre_trained_model <dir> --require_pretrained')")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs on the CPU (the tests); anything "
                    "else, or nothing, on the card")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.platform, "serving_quality")
    on_gpu = dev.type == "cuda"
    if not os.path.exists(os.path.join(REF_RAW, "valid")):
        print("reference valid shard unavailable", file=sys.stderr)
        return 2

    os.makedirs(args.out, exist_ok=True)
    dataroot = quality_smoke.write_split_dataroot(REF_RAW, args.out)

    from ..data.vocab import Memory

    memory = Memory.load(os.path.join(dataroot, "memory.json"))

    # the CLI nests the run under --experiment (utils/exp_dir.py): find
    # the trained directory by its model.ckpt
    exp_root = os.path.join(args.out, "exp")

    def find_exp_dir():
        hits = sorted(glob.glob(os.path.join(exp_root, "**", "model.ckpt"),
                                recursive=True))
        return os.path.dirname(hits[-1]) if hits else None

    exp_dir = find_exp_dir()
    if not (args.reuse and exp_dir):
        from ..cli import main as cli_main

        rc = cli_main([
            "--dataset", "dstc2_servq", "--dataroot", dataroot,
            "--n_layers", "4", "--n_head", "8",
            "--optim_choice", "bertadam",
            "--lr", "2e-4", "--bert_lr", "2e-4",
            "--warmup_proportion", "0.1",
            "--dropout", "0.1", "--bert_dropout", "0.1",
            "--batchSize", "32", "--max_epoch", str(args.epochs),
            "--random_seed", str(args.seed),
            "--compute_dtype", "bfloat16",
            "--length_buckets", "96,160,256",
            "--token_budget", "8192",
            "--add_segment_ids", "--eval_artifacts", "none",
            "--experiment", exp_root,
        ] + (args.extra.split() if args.extra else []), device=dev)
        if rc != 0:
            return rc
        exp_dir = find_exp_dir()
        if exp_dir is None:
            print(f"no model.ckpt produced under {exp_root}",
                  file=sys.stderr)
            return 1

    # rebuild the model config as the CLI run built it
    from ..config import parse_arguments
    from ..data.dataset import read_sep_data
    from ..data.tokenizer import load_tokenizer
    from ..serve import load_predictor
    from ..train.loop import build_model

    with open(os.path.join(exp_dir, "config.json")) as fp:
        snap = json.load(fp)
    argv = ["--dataset", snap["dataset"], "--dataroot", dataroot,
            "--n_layers", str(snap["n_layers"]),
            "--n_head", str(snap["n_head"]),
            "--compute_dtype", snap["compute_dtype"],
            "--experiment", exp_dir]
    if snap.get("tod_pre_trained_model"):
        argv += ["--tod_pre_trained_model", snap["tod_pre_trained_model"]]
    if snap.get("pre_trained_model"):
        argv += ["--pre_trained_model", snap["pre_trained_model"]]
    opt = parse_arguments(argv)
    tokenizer = load_tokenizer(opt.pre_trained_model,
                               opt.tod_pre_trained_model, memory)
    cfg, _ = build_model(opt, memory, tokenizer, dev)
    plain_cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, use_fused_attn=False, use_fused_ffn=False,
        use_flash_attention=False, use_fused_ln=False, use_fused_gelu=False,
        use_fused_embedding=False))

    arms = build_arms(on_gpu)
    results = {}
    per_arm_preds = {}
    for split in ("valid", "test"):
        raw = read_sep_data(os.path.join(dataroot, split))
        utts = [" ".join(s) for s in raw.asr_seqs]
        golds = raw.labels
        for arm, kw in arms.items():
            pred = load_predictor(
                exp_dir, memory, plain_cfg if arm in PLAIN_ARMS else cfg,
                tokenizer, device=dev,
                use_segments=bool(snap.get("add_segment_ids")),
                batch_size=args.batch_size, **kw)
            t0 = time.time()
            preds = pred.predict(utts)
            wall = time.time() - t0
            f1, acc = tuple_f1_acc(preds, golds)
            per_arm_preds[(split, arm)] = preds
            results[f"{split}/{arm}"] = {
                "f1": round(f1, 2), "acc": round(acc, 2),
                "wall_s": round(wall, 2)}
            del pred
        base = per_arm_preds[(split, "bf16_xla")]
        for arm in arms:
            results[f"{split}/{arm}"]["agree_vs_bf16"] = round(
                agreement(base, per_arm_preds[(split, arm)]), 2)

    md = ["| split | arm | F1 | Acc | agreement vs bf16 |",
          "|---|---|---|---|---|"]
    for key, r in results.items():
        split, arm = key.split("/")
        md.append(f"| {split} | {arm} | {r['f1']:.2f} | {r['acc']:.2f} "
                  f"| {r['agree_vs_bf16']:.2f}% |")
    table = "\n".join(md)
    print(table)
    with open(os.path.join(args.out, "serving_quality.json"), "w") as fp:
        json.dump({"results": results, "on_gpu": on_gpu,
                   "device": quality_smoke.device_text(dev),
                   "epochs": args.epochs, "seed": args.seed,
                   "extra": args.extra}, fp, indent=1)
    with open(os.path.join(args.out, "serving_quality.md"), "w") as fp:
        fp.write(table + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
