"""In-repo MLM pretraining: produce a LOCAL pretrained checkpoint for the
``--tod_pre_trained_model`` init path -- the port of
``tools/pretrain_mlm.py`` (``corpus_lines`` :47, ``train_wordpiece_vocab``
:61, ``pack_mlm_pool`` :102, ``main`` :146), with its flags, printed
lines and ``pretrain_meta.json`` keys.

1. trains a WordPiece vocab on the corpus text with the port's own
   trainer (``data/wordpiece_trainer.py``: HF's algorithm without
   ``tokenizers``, deterministic) and writes ``vocab.txt`` + BertTokenizer
   config files,
2. packs the corpus through the input-builder layouts with the new
   tokenizer (the port's ``WordPieceTokenizer`` on the written directory),
   both the ASR n-best and the transcript sides, by length bucket,
3. pretrains the encoder with the BERT MLM objective (``train/mlm.py``)
   under BertAdam: bf16 on the card with the kernel flags' "auto" -- the
   hand-written kernels -- and f32 on the CPU,
4. exports a HuggingFace-format checkpoint directory
   (``models/hf_convert.export_hf_checkpoint``) that the fine-tune CLI
   takes through ``--tod_pre_trained_model <dir> --require_pretrained``.

The batch sizes and the bucket and row schedule come from
``np.random.default_rng(seed)`` exactly as the JAX tool draws them, so
both tools visit the same buckets and rows for one seed.  The corpus is
the ``train`` shard under ``--dataroot``; without one the tool returns 2
(the JAX tool falls back to a reference shard outside the repository).

Run (card):  python -m nbest_asr_tpu_torch.tools.pretrain_mlm \\
    --dataroot DIR --out /tmp/mlm_ckpt
Smoke (CPU, tests):  python -m nbest_asr_tpu_torch.tools.pretrain_mlm \\
    --platform cpu --steps 20 --hidden 64 --n_layers 2 \\
    --vocab_size 512 --dataroot DIR --out /tmp/x
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                  "[SYS]", "[USR]"]


def corpus_lines(raw_split) -> list:
    """Plain text lines for vocab training: every utterance contributes its
    ASR n-best side and its transcript side, framing markers stripped (the
    markers are registered as special tokens, never WordPiece-split)."""
    drop = {"[CLS]", "[SYS]", "[USR]", "[SEP]"}
    lines = []
    for seqs in (raw_split.asr_seqs, raw_split.trans_seqs):
        for seq in seqs:
            words = [w for w in seq if w and w not in drop]
            if words:
                lines.append(" ".join(words))
    return lines


def train_wordpiece_vocab(lines, out_dir: str, vocab_size: int,
                          pad_multiple: int = 128) -> str:
    """Train a WordPiece vocab on the corpus and write the three files a
    ``BertTokenizer`` needs.  The vocab is padded with ``[unusedN]`` rows to
    a multiple of ``pad_multiple``, which keeps the embedding table's rows
    and the tied MLM decoder's N a multiple of 128 on the card."""
    from ..data.wordpiece_trainer import train_wordpiece

    inv, _ = train_wordpiece(lines, vocab_size, SPECIAL_TOKENS)
    n = len(inv)
    target = ((n + pad_multiple - 1) // pad_multiple) * pad_multiple
    inv += [f"[unused{i}]" for i in range(target - n)]

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vocab.txt"), "w") as fp:
        fp.write("\n".join(inv) + "\n")
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as fp:
        json.dump({"tokenizer_class": "BertTokenizer",
                   "do_lower_case": True,
                   "model_max_length": 512}, fp, indent=1)
    with open(os.path.join(out_dir, "special_tokens_map.json"), "w") as fp:
        json.dump({"pad_token": "[PAD]", "unk_token": "[UNK]",
                   "cls_token": "[CLS]", "sep_token": "[SEP]",
                   "mask_token": "[MASK]",
                   "additional_special_tokens": ["[SYS]", "[USR]"]},
                  fp, indent=1)
    return os.path.join(out_dir, "vocab.txt")


def pack_mlm_pool(raw_split, tokenizer, buckets, special_ids):
    """Both text sides -> per-bucket fixed-shape arrays + maskable masks."""
    from ..data.input_builder import build_inputs

    seq_pool = []  # (ids, segs)
    for seqs in (raw_split.asr_seqs, raw_split.trans_seqs):
        built = build_inputs(seqs, tokenizer, "default")
        for i, toks in enumerate(built.tokens):
            ids = tokenizer.convert_tokens_to_ids(toks)
            seq_pool.append((ids, built.segment_ids[i]))

    pad_id = tokenizer.pad_token_id
    by_bucket = {b: [] for b in buckets}
    n_dropped = 0
    for ids, segs in seq_pool:
        for b in buckets:
            if len(ids) <= b:
                by_bucket[b].append((ids, segs))
                break
        else:
            n_dropped += 1
    out = {}
    for b, rows in by_bucket.items():
        if not rows:
            continue
        n = len(rows)
        arr_ids = np.full((n, b), pad_id, np.int32)
        arr_seg = np.zeros((n, b), np.int32)
        arr_msk = np.zeros((n, b), np.float32)
        for i, (ids, segs) in enumerate(rows):
            L = len(ids)
            arr_ids[i, :L] = ids
            arr_seg[i, :L] = segs[:L]
            arr_msk[i, :L] = 1.0
        maskable = arr_msk > 0
        for sid in special_ids:
            maskable &= arr_ids != sid
        out[b] = {"input_ids": arr_ids, "segment_ids": arr_seg,
                  "attn_mask": arr_msk, "maskable": maskable}
    return out, n_dropped


def batch_sizes(pool, token_budget: int) -> dict:
    """Per-bucket batch rows from the token budget (JAX's :272-275)."""
    return {b: min(max(token_budget // b, 8), arrs["input_ids"].shape[0])
            for b, arrs in pool.items()}


def schedule(pool, batch_of: dict, seed: int):
    """The step schedule, JAX's :269-292: yields (bucket, row indices) per
    step from ``np.random.default_rng(seed)``, each bucket drawn with
    probability proportional to its total token count, rows from a fresh
    permutation whenever the current one runs out."""
    host_rng = np.random.default_rng(seed)
    bucket_ids = sorted(pool)
    bucket_p = np.array([pool[b]["input_ids"].shape[0] * b
                         for b in bucket_ids], dtype=np.float64)
    bucket_p /= bucket_p.sum()
    cursors = {b: None for b in pool}
    while True:
        b = bucket_ids[host_rng.choice(len(bucket_ids), p=bucket_p)]
        n = pool[b]["input_ids"].shape[0]
        bs = batch_of[b]
        if cursors[b] is None or cursors[b][1] + bs > n:
            cursors[b] = (host_rng.permutation(n), 0)
        perm, pos = cursors[b]
        cursors[b] = (perm, pos + bs)
        yield b, perm[pos:pos + bs]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True,
                    help="output checkpoint dir (HF format)")
    ap.add_argument("--dataroot", default=None,
                    help="dataroot whose `train` shard is the corpus "
                    "(required by the port)")
    ap.add_argument("--vocab_size", type=int, default=3000)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--n_layers", type=int, default=4)
    ap.add_argument("--n_heads", type=int, default=12)
    ap.add_argument("--intermediate", type=int, default=3072)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup", type=float, default=0.1)
    ap.add_argument("--mask_rate", type=float, default=0.15)
    ap.add_argument("--token_budget", type=int, default=8192)
    ap.add_argument("--buckets", default="96,288")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs on the CPU (the tests); anything "
                    "else, or nothing, on the card")
    ap.add_argument("--log_every", type=int, default=100)
    return ap.parse_args(argv)


def resolve_device(platform, tool: str = "pretrain_mlm") -> torch.device:
    """The CPU when ``platform`` is 'cpu', else the card, which must
    exist: every tool of the port takes its device from here."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"CUDA is not available: {tool} runs on an "
                           "NVIDIA GPU (pass --platform cpu for the CPU)")
    return torch.device("cuda", 0)


def main(argv=None) -> int:
    args = parse_args(argv)
    return 0 if run(args) is not None else 2


def run(args: argparse.Namespace):
    """The tool's work -> a dict of what it measured (``losses``: every
    step's loss, ``step_ms``: the mean time of the steps after the first,
    from CUDA events on the card, None on the CPU), or None where ``main``
    returns 2."""
    dev = resolve_device(args.platform)
    cuda = dev.type == "cuda"

    from ..data.dataset import read_sep_data
    from ..data.tokenizer import WordPieceTokenizer

    # ---- corpus -------------------------------------------------------
    if not args.dataroot:
        print("reference valid shard unavailable: pass --dataroot",
              file=sys.stderr)
        return None
    raw = read_sep_data(os.path.join(args.dataroot, "train"))
    text = corpus_lines(raw)
    print(f"corpus: {len(raw)} utterances, {len(text)} text lines",
          flush=True)

    # ---- vocab + tokenizer -------------------------------------------
    train_wordpiece_vocab(text, args.out, args.vocab_size)
    tokenizer = WordPieceTokenizer(args.out)
    # vocab.txt was padded; vocab_size must count the padded rows so the
    # embedding table matches the file
    with open(os.path.join(args.out, "vocab.txt")) as fp:
        vocab_size = sum(1 for _ in fp)
    print(f"wordpiece vocab: {vocab_size} (requested {args.vocab_size})",
          flush=True)

    special_ids = tokenizer.convert_tokens_to_ids(SPECIAL_TOKENS)
    mask_id = tokenizer.convert_tokens_to_ids(["[MASK]"])[0]
    buckets = [int(b) for b in args.buckets.split(",")]
    pool, n_dropped = pack_mlm_pool(raw, tokenizer, buckets, special_ids)
    if n_dropped:
        print(f"WARNING: {n_dropped} sequences longer than max bucket "
              f"{max(buckets)} dropped from pretraining", flush=True)
    for b, arrs in pool.items():
        print(f"bucket {b}: {arrs['input_ids'].shape[0]} sequences",
              flush=True)

    # ---- model + optimizer -------------------------------------------
    from ..models.encoder import EncoderConfig, init_encoder_params
    from ..train.mlm import init_mlm_head_params, make_mlm_train_step
    from ..train.optimizer import OptimizerConfig, make_optimizer, tree_map

    cfg = EncoderConfig(
        vocab_size=vocab_size, hidden_size=args.hidden,
        num_layers=args.n_layers, num_heads=args.n_heads,
        intermediate_size=args.intermediate, max_position=512,
        hidden_dropout=0.1, attn_dropout=0.1,
        compute_dtype="bfloat16" if cuda else "float32",
        use_flash_attention=cuda, use_fused_ffn=cuda, use_fused_attn=cuda)
    gen = torch.Generator().manual_seed(args.seed)
    params = {"encoder": init_encoder_params(gen, cfg),
              "mlm_head": init_mlm_head_params(gen, cfg)}
    params = tree_map(lambda t: t.to(dev), params)
    if cuda:
        from ..ops import _cuda

        _cuda.lib()         # build now: raises if nvcc or a build fails

    opt_cfg = OptimizerConfig(optim_choice="bertadam", lr=args.lr,
                              bert_lr=args.lr, t_total=args.steps,
                              warmup_proportion=args.warmup)
    tx = make_optimizer(opt_cfg, params)
    opt_state = tx.init(params)
    step_fn = make_mlm_train_step(cfg, tx, mask_id, args.mask_rate)

    # ---- loop ---------------------------------------------------------
    batch_of = batch_sizes(pool, args.token_budget)
    device_pool = {b: {k: torch.from_numpy(v).to(dev) for k, v in
                       arrs.items()} for b, arrs in pool.items()}
    plan = schedule(pool, batch_of, args.seed)

    print(f"pretraining: {args.steps} steps, lr {args.lr}, "
          f"batch sizes {batch_of}", flush=True)
    # the step time leaves out the first step (the first launches of the
    # process's kernels and library calls)
    timed_from = 1 if args.steps > 1 else 0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
        if cuda else None
    t0 = time.time()
    losses, all_losses, window = [], [], []
    for step in range(args.steps):
        if cuda and step == timed_from:
            events[0].record()
        b, idx = next(plan)
        sel = torch.from_numpy(idx).to(dev)
        batch = {k: v.index_select(0, sel)
                 for k, v in device_pool[b].items()}
        params, opt_state, loss = step_fn(params, opt_state, batch, gen)
        window.append(loss)
        all_losses.append(loss)
        if (step + 1) % args.log_every == 0 or step == args.steps - 1:
            w = [float(x) for x in window]
            losses.append({"step": step + 1,
                           "loss": sum(w) / len(w)})
            print(f"step {step + 1}/{args.steps}  "
                  f"mlm_loss {losses[-1]['loss']:.4f}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
            window = []
    step_ms = None
    if cuda:
        events[1].record()
        torch.cuda.synchronize(dev)
        step_ms = events[0].elapsed_time(events[1]) / max(
            args.steps - timed_from, 1)
    wall = time.time() - t0

    # ---- export -------------------------------------------------------
    from ..models.hf_convert import export_hf_checkpoint
    from ..train.mlm import mlm_head_export_state

    params = tree_map(lambda t: t.detach().cpu(), params)
    export_hf_checkpoint(
        cfg, params["encoder"], args.out,
        extra_state=mlm_head_export_state(
            params["mlm_head"], params["encoder"]["embeddings"]["word"]))
    with open(os.path.join(args.out, "pretrain_meta.json"), "w") as fp:
        json.dump({"steps": args.steps, "lr": args.lr,
                   "vocab_size": vocab_size, "buckets": buckets,
                   "batch_sizes": batch_of, "seed": args.seed,
                   "mask_rate": args.mask_rate, "wall_s": round(wall, 1),
                   "corpus_utterances": len(raw),
                   "final_loss": losses[-1]["loss"] if losses else None,
                   "loss_curve": losses}, fp, indent=1)
    print(f"exported HF checkpoint to {args.out}  "
          f"(final mlm_loss {losses[-1]['loss']:.4f}, wall {wall:.0f}s)",
          flush=True)
    return {"losses": [float(x) for x in all_losses], "step_ms": step_ms,
            "cfg": cfg, "batch_sizes": batch_of}


if __name__ == "__main__":
    raise SystemExit(main())
