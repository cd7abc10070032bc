"""Serving benchmark: batch-inference latency and throughput of the port's
``Predictor`` on DSTC2 utterances, on one card -- the port of
``tools/serve_bench.py``, with its flags and its JSON line's keys.

BERT-base in bf16 (vocab 30522, 12 layers, hidden 768; random weights from
``torch.Generator().manual_seed(0)``) over the ``valid`` shard's first
``--batch`` utterances and the hierarchy of ``memory.pt``, both under
``REF_RAW``.  It times the host packing alone, then synchronous
``predict`` calls (p50 and p95 of the request's wall time, which ends when
the labels are on the host), then ``predict_async`` with ``--depth``
requests in flight.  The kernel flags are the card's default (on) unless
``--no_fused``; ``--quantize`` picks the Predictor's serving mode (its
default resolves by ``serve.resolve_quantize``).  ``--tokenizer
wordpiece`` trains a 3000-row WordPiece vocab on the shard's text with the
port's own trainer (``data/wordpiece_trainer.py``) into a temporary
directory and serves through ``WordPieceTokenizer``.

Run: python -m nbest_asr_tpu_torch.tools.serve_bench [--batch 64]
         [--max_len 256] [--quantize int8|none] [--platform cpu]
Prints one JSON line: JAX's keys plus ``device``.  It runs on the card
unless ``--platform cpu``; without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from .pretrain_mlm import resolve_device

REF_RAW = "/root/reference/dstc2_data/processed_data/raw"


def model_config(vocab_size: int, fused: bool):
    """The served encoder: BERT-base in bf16 with the kernel flags."""
    from ..models.encoder import EncoderConfig

    return EncoderConfig.bert_base(vocab_size=vocab_size,
                                   compute_dtype="bfloat16",
                                   use_fused_attn=fused, use_fused_ffn=fused)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max_len", type=int, default=256)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--quantize", choices=["int8", "none"], default=None,
                    help="int8 encoder GEMMs (ops/quant.py; with the kernel "
                    "flags on, the int8 serving kernels).  Default: the "
                    "Predictor's rule (serve.resolve_quantize); 'none' "
                    "forces bf16")
    ap.add_argument("--no_fused", action="store_true",
                    help="the plain serving path (every kernel flag off)")
    ap.add_argument("--depth", type=int, default=2,
                    help="async pipeline depth (in-flight predict_async "
                    "handles)")
    ap.add_argument("--fused_attn_eval", action="store_true", default=None,
                    help="force the attention kernels on the deterministic "
                    "forward (the Predictor's default on the card)")
    ap.add_argument("--no_fused_attn_eval", dest="fused_attn_eval",
                    action="store_false",
                    help="force the plain eval attention")
    ap.add_argument("--tokenizer", choices=["word", "wordpiece"],
                    default="word",
                    help="'wordpiece' serves through a BERT WordPiece "
                    "tokenizer trained on the shard text (the "
                    "pretrained-family packing path)")
    ap.add_argument("--no_native_pack", action="store_true",
                    help="disable the C++ packer (measures the Python "
                    "host packing)")
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs on the CPU (the tests); anything "
                    "else, or nothing, on the card")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    dev = resolve_device(args.platform, "serve_bench")
    from ..data.dataset import read_sep_data
    from ..data.tokenizer import WordPieceTokenizer, WordVocabTokenizer
    from ..data.vocab import Memory
    from ..models.model import ModelConfig, init_model_params
    from ..serve import Predictor
    from .pretrain_mlm import corpus_lines, train_wordpiece_vocab

    memory = Memory.from_torch_pt(os.path.join(REF_RAW, "memory.pt"))
    split = read_sep_data(os.path.join(REF_RAW, "valid"))
    with tempfile.TemporaryDirectory() as tok_dir:
        vocab_size = 30522
        if args.tokenizer == "wordpiece":
            train_wordpiece_vocab(corpus_lines(split), tok_dir, 3000)
            tok = WordPieceTokenizer(tok_dir)
            with open(os.path.join(tok_dir, "vocab.txt")) as fp:
                vocab_size = sum(1 for _ in fp)
        else:
            tok = WordVocabTokenizer(memory)
        fused = dev.type == "cuda" and not args.no_fused
        cfg = ModelConfig(encoder=model_config(vocab_size, fused),
                          n_top=memory.n_top, n_bottom=memory.n_bottom)
        params = init_model_params(torch.Generator().manual_seed(0), cfg)
        pred = Predictor(params, cfg, memory, tok, device=dev,
                         batch_size=args.batch, max_len=args.max_len,
                         quantize=args.quantize,
                         fused_attn_eval=args.fused_attn_eval)
    if args.no_native_pack:
        pred._native = None
    native_pack = pred._native is not None

    utts = [" ".join(s) for s in split.asr_seqs[: args.batch]]
    pred.predict(utts)  # the process's first launches, and warm-up

    # host packing cost in isolation (tokenize + layout + pad)
    seqs = [u.split() for u in utts]
    pack_ms = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        pred._pack(seqs)
        pack_ms.append((time.perf_counter() - t0) * 1000)

    lat = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        pred.predict(utts)
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1000

    # pipelined: `depth` requests in flight through predict_async
    handles = []
    t0 = time.perf_counter()
    for _ in range(args.iters):
        handles.append(pred.predict_async(utts))
        if len(handles) > args.depth:
            handles.pop(0).result()
    for h in handles:
        h.result()
    async_dt = time.perf_counter() - t0

    return {
        "metric": "dstc2_serving",
        "quantize": pred.quantize,
        "tokenizer": args.tokenizer,
        "native_pack": native_pack,
        "host_pack_p50_ms": round(float(np.percentile(pack_ms, 50)), 2),
        "batch": args.batch,
        "latency_p50_ms": round(float(np.percentile(lat_ms, 50)), 2),
        "latency_p95_ms": round(float(np.percentile(lat_ms, 95)), 2),
        "utterances_per_sec": round(
            args.batch / (lat_ms.mean() / 1000), 1),
        "async_depth2_utterances_per_sec": round(
            args.batch * args.iters / async_dt, 1),
        "async_depth2_ms_per_batch": round(
            async_dt / args.iters * 1000, 2),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
