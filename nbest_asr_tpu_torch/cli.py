"""CLI entry point -- ``python -m nbest_asr_tpu_torch.cli <flags>``, the
port of ``nbest_asr_tpu/cli.py`` (``resolve_memory`` :23,
``prepare_packed_splits`` :34, ``main`` :100).

The same flags (``config.py``), log lines, return codes and artifact
layout under the experiment directory as the JAX package's CLI.  It runs
on the card: ``--deviceId -1`` (the default) is ``cuda:0``, ``--deviceId
N`` is ``cuda:N``.  The CPU is reached only when a caller passes
``device="cpu"`` to ``main``, as the tests do; without CUDA and without
that, ``main`` raises rather than train on the CPU.

Several processes train one model under torchrun::

    python -m torch.distributed.run --nproc_per_node N \
        -m nbest_asr_tpu_torch.cli ... --n_model_parallel T \
        [--data_mode direct]

With ``WORLD_SIZE`` > 1 each rank runs on ``cuda:<LOCAL_RANK>`` (unless
the caller passes ``device=``) and joins the process group
(``parallel/mesh.init_distributed``: NCCL on the card, gloo on the CPU;
nothing falls back to one process), which ``main`` destroys on its way
out, after an error too; a caller that set up its own group first keeps
it.  The ranks form the mesh of N / T data-parallel by T tensor-parallel
ranks; a world size that T does not divide returns 2.  Rank 0 alone
writes the experiment directory and prints the metric lines.  Refused flags
(``config.unsupported``) return 2 with their message.  The tokenizer
comes from ``data/tokenizer.load_tokenizer``, as at
``nbest_asr_tpu/cli.py:121-127``: a pretrained checkpoint's when one is
requested, else the word-vocab tokenizer; a requested checkpoint that
fails to load under ``--require_pretrained`` returns 2 with the error.
"""

from __future__ import annotations

import glob
import os
import random
import sys

import numpy as np
import torch
import torch.distributed as dist

from .config import RunOptions, parse_arguments, unsupported
from .data.dataset import read_sep_data
from .data.input_builder import pack_split
from .data.tokenizer import load_tokenizer
from .data.vocab import Memory
from .parallel.mesh import init_distributed, is_coordinator, world_size


def resolve_memory(opt: RunOptions) -> Memory:
    """memory.json preferred; reference-format memory.pt accepted
    (ref loads `dataroot/memory.pt`, :489)."""
    for candidate in (opt.memory_file, "memory.json", "memory.pt"):
        path = os.path.join(opt.dataroot, candidate)
        if os.path.exists(path):
            return Memory.load(path)
    raise FileNotFoundError(
        f"no memory bundle (memory.json/memory.pt) under {opt.dataroot}")


def prepare_packed_splits(opt: RunOptions, memory: Memory, tokenizer):
    """Read, coverage-sample (train only, ref :524-526), tokenize and pack
    every split present with one shared static max_len, on the Python
    packer (JAX's oracle and fallback; ``config`` says why)."""
    paths = {
        "train": os.path.join(opt.dataroot, opt.train_file),
        "valid": os.path.join(opt.dataroot, opt.valid_file),
        "test": os.path.join(opt.dataroot, opt.test_file),
    }
    raw = {}
    for name, path in paths.items():
        if os.path.exists(path):  # tolerate missing shards
            coverage = opt.coverage if name == "train" else None
            raw[name] = read_sep_data(path, coverage)

    def pack(name, max_len):
        return pack_split(raw[name], tokenizer, memory, layout=opt.layout,
                          max_len=max_len, len_multiple=opt.len_multiple)

    # one static max_len across splits
    splits = {name: pack(name, opt.max_seq_len) for name in raw}
    if opt.max_seq_len is None and splits:
        # unify to the largest packed length, re-pack the shorter ones
        target = max(p.max_len for p in splits.values())
        for name, packed in list(splits.items()):
            if packed.max_len != target:
                splits[name] = pack(name, target)
    return splits


def resolve_device(opt: RunOptions, device=None) -> torch.device:
    """``device`` when the caller gives one; else ``cuda:<LOCAL_RANK>``
    under torchrun with more than one rank, else ``cuda:<deviceId>`` (-1:
    ``cuda:0``), which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port's CLI trains on "
                           "an NVIDIA GPU (pass device='cpu' to main() to "
                           "run on the CPU)")
    if world_size() > 1 and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", max(opt.deviceId, 0))


def main(argv=None, *, device=None) -> int:
    opt = parse_arguments(argv)
    refused = unsupported(opt)
    if refused:
        for msg in refused:
            print(f"error: {msg}", file=sys.stderr)
        return 2
    world = world_size()
    if opt.n_model_parallel < 1 or world % opt.n_model_parallel:
        print(f"error: --n_model_parallel {opt.n_model_parallel} does not "
              f"divide the world size {world}", file=sys.stderr)
        return 2
    dev = resolve_device(opt, device)
    owned = world > 1 and init_distributed(dev)
    try:
        return _run(opt, dev)
    finally:
        if owned:
            dist.destroy_process_group()


def _run(opt: RunOptions, dev: torch.device) -> int:
    # global seeding (ref :128-133)
    random.seed(opt.random_seed)
    np.random.seed(opt.random_seed)

    try:
        memory = resolve_memory(opt)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        tokenizer = load_tokenizer(
            opt.pre_trained_model, opt.tod_pre_trained_model, memory,
            require_pretrained=opt.require_pretrained)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    splits = prepare_packed_splits(opt, memory, tokenizer)
    if "valid" not in splits:
        print("missing valid shard", file=sys.stderr)
        return 2
    if "train" not in splits and not opt.testing:
        print("missing train shard (training mode)", file=sys.stderr)
        return 2

    from .train.loop import Trainer, build_model

    try:
        cfg, params = build_model(opt, memory, tokenizer, dev)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if dev.type == "cuda":
        from .ops import _cuda

        _cuda.lib()         # build now: raises if nvcc or a build fails
    if is_coordinator():
        os.makedirs(opt.exp_dir, exist_ok=True)
    trainer = Trainer(opt, memory, cfg, params, splits,
                      family=opt.pre_trained_model, device=dev)

    if opt.testing:
        trainer.test()
    else:
        if opt.resume == "auto":
            # preemption recovery: pick up the newest checkpoint in the
            # experiment dir
            ckpts = sorted(
                (p for p in
                 glob.glob(os.path.join(opt.exp_dir, "ckpt_epoch*"))
                 + glob.glob(os.path.join(opt.exp_dir, "model.ckpt"))
                 if not p.endswith(".meta.json")),
                key=os.path.getmtime)
            if ckpts:
                if is_coordinator():
                    print(f"resuming from {ckpts[-1]}")
                trainer.load_checkpoint(ckpts[-1])
        elif opt.resume:
            trainer.load_checkpoint(opt.resume)
        trainer.train()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
