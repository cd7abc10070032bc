"""Training and eval: the epoch loop, checkpoints, dumps and logs -- the
port of ``nbest_asr_tpu/train/loop.py`` (``_host_data`` :66,
``_Bucket`` / ``_make_buckets`` :91-118, ``_epoch_step_indices`` :121,
``EpochMetrics`` :142, ``Trainer`` :150, the direct epoch :405-420,
``build_model`` :795).

As in the JAX package:

- per epoch: train -> eval(valid) -> eval(test), with [Train] / [Valid] /
  [Test] metric lines in the reference's log format (ref :405-424);
- per-utterance ``valid.iter<i>[.err]`` / ``test.iter<i>[.err]`` dumps in
  the ``input \\t<=>\\t preds \\t<=>\\t golds`` format (ref :357-364);
- observability CSVs and per-label classification reports per split
  (``utils/observability.py``);
- best-valid-F1 checkpoints with the optimizer state and step, so a run
  resumes mid-training (``--resume``, SIGTERM -> checkpoint at the epoch
  boundary), and a working ``--testing``.

Train F1 / accuracy come from the step's on-device counters; eval F1 /
accuracy from the host's string metrics.  The train mean loss divides by
the fixed micro-batch size times the micros run (by the utterance count
for packed epochs), the eval mean loss by the real utterance count.

Over a process mesh (``parallel/mesh.py``; ``Trainer(..., mesh=...)``,
by default ``make_mesh(n_model=opt.n_model_parallel)`` over the process
group, one rank without one) every rank runs the same epoch loop:

- ``--data_mode index``: every rank holds every split, and the train step
  takes its dp rows of each global micro.  This is JAX's single-controller
  index mode, which the port runs at any world size; JAX refuses it with
  more than one process only because there a process is a host that
  cannot hold the whole split on its devices.
- ``--data_mode direct``: each dp rank trains on its strided shard of
  the train split (``parallel/process_data.ProcessTrainShard``), whose
  plan with one process is index mode's; the eval splits stay on the
  index path.  ``--pack_examples`` keeps JAX's refusal there.
- Rank 0 alone writes (``parallel/mesh.is_coordinator``, JAX's
  ``_is_coordinator`` :56: several ranks would write the same paths):
  the dumps, the observability CSVs and reports, ``config.json``,
  ``best.json``, the log and the checkpoints.  A checkpoint holds the
  gathered full tree (``gather_params``) and its optimizer moments, in
  the one-device format, so a tp = 2 checkpoint resumes at tp = 1 and
  loads in ``serve.load_predictor``; resume reads the full tree and
  shards it, and takes rank 0's dropout and shuffle states.

What the port does differently:

- no replicated global arrays: each rank computes on its own rows and
  the step sums gradients and statistics over the dp group;
- no step chaining: ``run_train_epoch`` builds JAX's plan list with the
  same ``RandomState`` draws, chains of ``steps_per_call`` steps
  included, and runs a chain as its steps in order, so at dropout 0 the
  data order is JAX's;
- dropout seeds come from a CPU ``torch.Generator`` seeded by
  ``random_seed`` in place of the JAX key (``parallel/train_step.py``
  draws one seed per micro from it);
- checkpoints replace Orbax: ``torch.save`` of {params, opt_state, step}
  with every tensor on the CPU, and the same JSON sidecar
  (``<path>.meta.json``: epoch, best, the dropout generator's state as a
  list of ints under "rng", the shuffle ``RandomState`` under "shuffle").
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import RunOptions
from ..data.input_builder import PackedSplit
from ..data.vocab import Memory
from ..models.heads import hierarchy_device_arrays, init_head_params
from ..models.model import ModelConfig, init_model_params
from ..parallel.mesh import (gather_params, is_coordinator, make_mesh,
                             shard_params)
from ..parallel.train_step import (TrainState, make_eval_step,
                                   make_train_step)
from ..train.losses import LossConfig
from ..train.metrics import compute_f1, host_eval_metrics
from ..train.optimizer import OptimizerConfig, make_optimizer, tree_map
from ..utils.logging import make_logger
from ..utils.observability import EpochInfo, observability_lens


def _silent_logger():
    """The logger of a rank that is not the coordinator: it writes and
    prints nothing."""
    import logging

    logger = logging.getLogger("nbest_asr_tpu_torch.rank")
    logger.propagate = False
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger


def _host_data(packed: PackedSplit, *, use_asr_segments: bool,
               use_trans_segments: bool) -> Dict[str, np.ndarray]:
    """PackedSplit -> host numpy dict.  Segment streams the layout doesn't
    use are zeros (token type 0, identical to passing None).  Quirk kept:
    the reference drops ASR segment ids unless ``--add_segment_ids`` but
    always passes transcript segment ids (`n_best_asr_bert.py:252-255`)."""
    segs = packed.segment_ids if use_asr_segments else \
        np.zeros_like(packed.segment_ids)
    tsegs = packed.trans_segment_ids if use_trans_segments else \
        np.zeros_like(packed.trans_segment_ids)
    return {
        "input_ids": packed.input_ids,
        "attn_mask": packed.attn_mask,
        "segment_ids": segs,
        "trans_input_ids": packed.trans_input_ids,
        "trans_attn_mask": packed.trans_attn_mask,
        "trans_segment_ids": tsegs,
        "labels": packed.labels,
    }


def _to_device(data: Dict[str, np.ndarray], device) -> Dict[str,
                                                             torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in data.items()}


@dataclass
class _Bucket:
    """One length bucket: device tensors truncated to the bucket length,
    plus the original row indices for reassembly."""
    data: Dict[str, torch.Tensor]
    rows: np.ndarray          # original row indices (host)

    def __len__(self) -> int:
        return len(self.rows)


def _make_buckets(data: Dict[str, np.ndarray], bucket_lens: List[int],
                  device) -> List[_Bucket]:
    """Split host data into per-length buckets (``data/bucketing.py``) and
    copy each bucket to the device once.  Rows are never truncated,
    whatever bucket ladder the user passes."""
    from ..data.bucketing import bucket_assignment, row_lengths, slice_rows

    max_len = int(data["input_ids"].shape[1])
    return [_Bucket(data=_to_device(slice_rows(data, rows, blen), device),
                    rows=rows)
            for blen, rows in bucket_assignment(row_lengths(data),
                                                bucket_lens, max_len)]


def _epoch_step_indices(n: int, micro_b: int, n_accum: int,
                        perm: np.ndarray) -> np.ndarray:
    """Shuffled row order -> (n_steps, n_accum, micro_b) index array.

    Chunks of ``micro_b`` follow the permutation; the final short chunk is
    padded with the sentinel ``n`` (masked on the device).  Only full
    groups of ``n_accum`` micros step the optimizer -- trailing micros are
    dropped, as the reference zeroes their accumulated grads without ever
    stepping (ref :236, :266-280)."""
    n_micro = -(-n // micro_b)
    padded = np.full((n_micro * micro_b,), n, dtype=np.int32)
    padded[:n] = perm.astype(np.int32)
    micros = padded.reshape(n_micro, micro_b)
    n_steps = n_micro // n_accum
    if n_steps == 0:
        raise ValueError(
            f"dataset too small: {n_micro} microbatches < n_accum={n_accum}")
    return micros[: n_steps * n_accum].reshape(n_steps, n_accum, micro_b)


@dataclass
class EpochMetrics:
    mean_loss: float
    precision: float
    recall: float
    f1: float
    acc: float


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _state_dict(state, full=lambda t: t) -> dict:
    """An optimizer state (a NamedTuple of ints and tensor trees) as plain
    dicts on the CPU, which ``torch.load(weights_only=True)`` reads back;
    ``full`` maps each tree first (the gather of a sharded one)."""
    return {k: _tree_to(full(v) if isinstance(v, dict) else v, "cpu")
            for k, v in state._asdict().items()}


class Trainer:
    """Owns the train and eval steps, the device data, the optimizer
    state and the epoch loop, on ``device`` (default: the device of
    ``params``), on this rank of ``mesh``.  ``params`` is the full tree;
    under tensor parallelism the Trainer keeps this rank's shards."""

    def __init__(self, opt: RunOptions, memory: Memory,
                 model_cfg: ModelConfig, params: dict,
                 packed: Dict[str, PackedSplit], logger=None,
                 family: Optional[str] = None, device=None, mesh=None):
        self.opt = opt
        self.memory = memory
        self.cfg = model_cfg
        self.packed = packed
        self.family = family or (opt.pre_trained_model or "bert")
        self.device = torch.device(device) if device is not None else \
            params["head"][next(iter(params["head"]))].device
        self.mesh = mesh if mesh is not None else make_mesh(
            n_model=opt.n_model_parallel)
        self.logger = logger
        self.hier = hierarchy_device_arrays(memory.arrays(), self.device)

        # segment-id routing (see _host_data)
        is_xlmr = self.family == "xlm-roberta"
        use_asr_segs = opt.add_segment_ids and not is_xlmr
        use_trans_segs = not is_xlmr
        self.data = {
            name: _host_data(p, use_asr_segments=use_asr_segs,
                             use_trans_segments=use_trans_segs)
            for name, p in packed.items()
        }

        bucket_lens: List[int] = []
        if opt.length_buckets:
            bucket_lens = sorted(
                int(x) for x in opt.length_buckets.split(",") if x)
        # --data_mode direct: each dp rank trains on its shard of the
        # train split; the eval splits stay on the index path
        self.direct_data = opt.data_mode == "direct"
        self._shard = None
        # example packing (train only; data/packing.py): several
        # utterances per fixed-shape row, one packed "bucket"
        self._packed_train = bool(opt.pack_examples) and "train" in self.data
        if self._packed_train and self.direct_data:
            raise ValueError("--pack_examples is an index-mode feature; "
                             "--data_mode direct packs per process shard "
                             "(not implemented)")
        self.buckets: Dict[str, List[_Bucket]] = {}
        for name, d in self.data.items():
            if self.direct_data and name == "train":
                from ..parallel.process_data import ProcessTrainShard

                self._shard = ProcessTrainShard(
                    d, bucket_lens, process_index=self.mesh.dp_rank,
                    process_count=self.mesh.dp_size)
            elif name == "train" and self._packed_train:
                from ..data.packing import pack_train_data

                pk, bins = pack_train_data(d, opt.pack_capacity,
                                           opt.pack_max_segs)
                if self.logger:
                    real = int(sum(len(b) for b in bins))
                    cap = pk["input_ids"].shape[1]
                    fill = float(pk["attn_mask"].astype(bool).sum()) / (
                        len(bins) * cap)
                    self.logger.info(
                        "packed train: %d utterances -> %d rows of %d "
                        "tokens (%.1f%% occupancy)"
                        % (real, len(bins), cap, 100 * fill))
                self.buckets[name] = [_Bucket(
                    data=_to_device(pk, self.device),
                    rows=np.arange(len(bins)))]
            elif bucket_lens:
                self.buckets[name] = _make_buckets(d, bucket_lens,
                                                   self.device)
            else:
                self.buckets[name] = [_Bucket(
                    data=_to_device(d, self.device),
                    rows=np.arange(len(packed[name])))]

        # the schedule's horizon: the reference formula
        # `(n_train // batchSize + 1) * max_epoch` (ref :556) in the parity
        # configuration; with buckets, a token budget or packing, the real
        # step count of an epoch (shuffling permutes rows, never counts)
        n_train = len(packed["train"]) if "train" in packed else 1
        if (opt.token_budget or opt.length_buckets
                or self._packed_train) and "train" in packed:
            t_total = max(self._train_steps_per_epoch(), 1) * opt.max_epoch
        else:
            t_total = (n_train // opt.batchSize + 1) * opt.max_epoch
        # --fix_bert_model freezes the encoder at the optimizer level;
        # bert_lr 0 kept as belt-and-braces for the per-leaf-lr modes
        bert_lr = 0.0 if opt.fix_bert_model else opt.bert_lr
        self.opt_cfg = OptimizerConfig(
            optim_choice=opt.optim_choice, lr=opt.lr, bert_lr=bert_lr,
            warmup_proportion=opt.warmup_proportion, t_total=t_total,
            max_grad_norm=1.0 if opt.optim_choice == "bertadam"
            else opt.max_norm,
            l2=opt.l2, freeze_encoder=opt.fix_bert_model)
        params = _tree_to(shard_params(params, self.mesh), self.device)
        self.optimizer = make_optimizer(self.opt_cfg, params, self.mesh)

        # the transcript stream feeds only the optional MSE alignment term
        # (ref :166-170): without --add_l2_loss its pass is skipped
        self.train_step = make_train_step(
            model_cfg, LossConfig(add_l2_loss=opt.add_l2_loss),
            self.optimizer, self.hier, n_accum=opt.n_accum_steps,
            dual_stream=bool(opt.add_l2_loss), mesh=self.mesh,
            data_mode=opt.data_mode)
        self.steps_per_call = max(1, opt.steps_per_call)
        self.eval_step = make_eval_step(
            model_cfg, LossConfig(add_l2_loss=opt.add_l2_loss), self.hier,
            dual_stream=False, mesh=self.mesh)

        self.state = TrainState(params=params,
                                opt_state=self.optimizer.init(params),
                                step=0)
        self._gen = torch.Generator().manual_seed(opt.random_seed)
        self._shuffle_rng = np.random.RandomState(opt.random_seed)
        # resume bookkeeping (set by load_checkpoint)
        self._start_epoch = 0
        self._best: Optional[Dict[str, float]] = None

    # ------------------------------------------------------------------ #
    # epochs
    # ------------------------------------------------------------------ #

    def run_train_epoch(self) -> EpochMetrics:
        opt = self.opt
        K = self.steps_per_call
        # per-bucket step plans (bucket-local indices): JAX's chains of K
        # steps and leftover single steps, the plan order shuffled
        # globally; a chain runs here as its K steps in order
        plans = []  # ("chain"|"single", bucket, idx)
        n_rows_total = 0
        for bucket, micro_b, idx in self._bucket_step_indices():
            n_steps = idx.shape[0]
            n_rows_total += n_steps * opt.n_accum_steps * micro_b
            n_chains = n_steps // K if K > 1 else 0
            for c in range(n_chains):
                plans.append(("chain", bucket, idx[c * K:(c + 1) * K]))
            for s in range(n_chains * K, n_steps):
                plans.append(("single", bucket, idx[s]))
        self._shuffle_rng.shuffle(plans)

        stats_acc = None
        for kind, bucket, idx_s in plans:
            for idx in (idx_s if kind == "chain" else (idx_s,)):
                if self.direct_data:    # this rank's rows, then no idx
                    data, idx = _to_device(
                        self._shard.local_batch(bucket, idx),
                        self.device), None
                else:
                    data, idx = bucket.data, torch.from_numpy(idx).to(
                        self.device)
                self.state, stats = self.train_step(self.state, data, idx,
                                                    self._gen)
                stats_acc = stats if stats_acc is None else tree_map(
                    torch.add, stats_acc, stats)
        return self._metrics_from_counts(
            stats_acc, None if self._packed_train else n_rows_total)

    def _bucket_step_indices(self):
        """[(bucket, micro_b, (n_steps, n_accum, b) indices)] of one
        epoch, one shuffle permutation drawn per bucket: the index path's
        buckets and global rows, or in direct mode the shard's bucket ids
        and this rank's rows (``ProcessTrainShard.epoch_plan``, which
        draws as the index path does)."""
        n_accum = self.opt.n_accum_steps
        if self.direct_data:
            return self._shard.epoch_plan(
                self._shuffle_rng, self._micro_batch_for_len, n_accum)
        out = []
        for bucket in self.buckets["train"]:
            micro_b = self._bucket_micro_batch(bucket)
            perm = self._shuffle_rng.permutation(len(bucket))
            try:
                out.append((bucket, micro_b, _epoch_step_indices(
                    len(bucket), micro_b, n_accum, perm)))
            except ValueError:
                continue  # bucket smaller than one accumulation group
        return out

    def _micro_batch_for_len(self, blen: int) -> int:
        """Micro-batch for one bucket length: the parity batch by default;
        under --token_budget, ~budget/bucket_len rounded to a multiple of
        8 (never below the parity micro-batch)."""
        opt = self.opt
        if not opt.token_budget:
            return opt.micro_batch
        b = max(opt.micro_batch, (opt.token_budget // blen) // 8 * 8)
        return max(b, 1)

    def _bucket_micro_batch(self, bucket: _Bucket) -> int:
        return self._micro_batch_for_len(
            int(bucket.data["input_ids"].shape[1]))

    def _train_steps_per_epoch(self) -> int:
        """Optimizer steps one train epoch will take (independent of the
        shuffle: permutations change row order, never counts)."""
        if self._shard is not None:
            return self._shard.steps_per_epoch(self._micro_batch_for_len,
                                               self.opt.n_accum_steps)
        steps = 0
        for bucket in self.buckets.get("train", []):
            micro_b = self._bucket_micro_batch(bucket)
            n_micro = -(-len(bucket) // micro_b)
            steps += n_micro // self.opt.n_accum_steps
        return steps

    def run_eval_epoch(self, split: str, epoch: int = 0,
                       dump_prefix: Optional[str] = None
                       ) -> tuple[EpochMetrics, EpochInfo]:
        opt = self.opt
        packed = self.packed[split]
        n = len(packed)
        eval_b = opt.eval_batch or opt.micro_batch

        # every batch is enqueued before any result is read: one copy to
        # the host per bucket, and one for the loss sums at the end
        pred_mh = np.zeros((n, self.memory.n_bottom), dtype=bool)
        loss_parts = []
        for bucket in self.buckets[split]:
            nb = len(bucket)
            b_eval = eval_b
            if opt.token_budget:
                blen = int(bucket.data["input_ids"].shape[1])
                b_eval = max(eval_b, (opt.token_budget // blen) // 8 * 8)
            n_batches = -(-nb // b_eval)
            padded = np.full((n_batches * b_eval,), nb, dtype=np.int32)
            padded[:nb] = np.arange(nb, dtype=np.int32)
            idx = torch.from_numpy(padded).to(self.device)
            bucket_preds = []
            for bidx in idx.reshape(n_batches, b_eval):
                out = self.eval_step(self.state.params, bucket.data, bidx)
                bucket_preds.append(out["pred"])
                loss_parts.append(out["loss"]["total"])
            bp = torch.cat(bucket_preds).cpu().numpy()[:nb]
            pred_mh[bucket.rows] = bp.astype(bool)
        loss_sum = float(np.sum(torch.stack(loss_parts).cpu().numpy())) \
            if loss_parts else 0.0

        (p, r, f), acc, pred_strings, golds = host_eval_metrics(
            pred_mh, packed.raw_labels, self.memory.idx2label,
            ontology=opt.ontology)
        # padded sentinel rows are zeroed out of the loss by example_mask,
        # so the real row count is the denominator
        mean_loss = loss_sum / max(n, 1)

        raw_inputs = [" ".join(s) for s in packed.raw_asr]
        matches = [set(pc) == set(g) for pc, g in
                   zip(pred_strings, golds)]
        info = EpochInfo(raw_inputs, pred_strings, golds, matches,
                         mean_loss, p, r, f, acc)

        if dump_prefix is not None and is_coordinator():
            self._write_dumps(dump_prefix, packed, pred_strings, golds)

        return EpochMetrics(mean_loss, p, r, f, acc), info

    def _write_dumps(self, prefix: str, packed: PackedSplit,
                     preds: List[List[str]], golds: List[List[str]]
                     ) -> None:
        """`input \\t<=>\\t preds \\t<=>\\t golds` per line; errors also to
        the .err file (ref :357-364)."""
        with open(prefix, "w") as fp, open(prefix + ".err", "w") as efp:
            for raw, pc, gold in zip(packed.raw_asr, preds, golds):
                line = "%s\t<=>\t%s\t<=>\t%s\n" % (
                    " ".join(raw), ";".join(pc), ";".join(gold))
                fp.write(line)
                if set(pc) != set(gold):
                    efp.write(line)

    def _metrics_from_counts(self, stats,
                             n_rows: Optional[int]) -> EpochMetrics:
        c = {k: float(v) for k, v in stats["counts"].items()}
        p, r, f = compute_f1(c["tp"], c["fp"], c["fn"])
        total = max(c["total"], 1.0)
        acc = c["correct"] / total * 100
        # n_rows None (packed epochs): rows hold several utterances, so
        # the on-device utterance count is the loss denominator
        denom = total if n_rows is None else max(n_rows, 1)
        mean_loss = float(stats["loss"]["total"]) / denom
        return EpochMetrics(mean_loss, p, r, f, acc)

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #

    def save_checkpoint(self, path: str, *, epoch: Optional[int] = None,
                        best: Optional[Dict[str, float]] = None) -> None:
        """{params, opt_state, step} with every tensor on the CPU, and a
        JSON sidecar with the epoch cursor, the best-metrics dict and both
        random states -- everything ``train()`` needs to continue a
        stopped run exactly where it stopped.  ``epoch`` is the NEXT epoch
        to run on resume.  Every rank gathers the full trees (a
        collective under tensor parallelism); the coordinator writes."""
        path = os.path.abspath(path)

        def full(tree):
            return gather_params(tree, self.mesh,
                                 self.cfg.encoder.vocab_size)

        params = _tree_to(full(self.state.params), "cpu")
        opt_state = _state_dict(self.state.opt_state, full)
        if not is_coordinator():
            return
        torch.save({"params": params, "opt_state": opt_state,
                    "step": int(self.state.step)}, path)
        mt = self._shuffle_rng.get_state()
        meta = {
            "epoch": epoch,
            "best": best,
            "rng": self._gen.get_state().tolist(),
            "shuffle": [mt[0], np.asarray(mt[1]).tolist(), int(mt[2]),
                        int(mt[3]), float(mt[4])],
        }
        with open(path + ".meta.json", "w") as fp:
            json.dump(meta, fp)

    def load_checkpoint(self, path: str) -> None:
        """Every rank reads the full trees and keeps its shards; the
        sidecar's cursor and random states are rank 0's, broadcast."""
        path = os.path.abspath(path)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)

        def local(tree):
            return _tree_to(shard_params(tree, self.mesh), self.device)

        opt_state = type(self.state.opt_state)(**{
            k: local(v) if isinstance(v, dict) else v
            for k, v in ckpt["opt_state"].items()})
        self.state = TrainState(params=local(ckpt["params"]),
                                opt_state=opt_state, step=int(ckpt["step"]))
        meta_path = path + ".meta.json"
        meta = None
        if is_coordinator() and os.path.exists(meta_path):
            with open(meta_path) as fp:
                meta = json.load(fp)
        if torch.distributed.is_initialized():
            box = [meta]
            torch.distributed.broadcast_object_list(box, src=0)
            meta = box[0]
        if meta is not None:
            if meta.get("epoch") is not None:
                self._start_epoch = int(meta["epoch"])
            if meta.get("best") is not None:
                self._best = dict(meta["best"])
            if meta.get("rng") is not None:
                self._gen.set_state(torch.tensor(meta["rng"],
                                                 dtype=torch.uint8))
            if meta.get("shuffle") is not None:
                kind, keys, pos, hg, cached = meta["shuffle"]
                self._shuffle_rng.set_state(
                    (kind, np.asarray(keys, dtype=np.uint32), pos, hg,
                     cached))

    # ------------------------------------------------------------------ #
    # whole runs
    # ------------------------------------------------------------------ #

    def train(self, stop_after_epoch: Optional[int] = None
              ) -> Dict[str, float]:
        """The epoch loop.  ``stop_after_epoch`` stops after that epoch index
        as a SIGTERM would (checkpoint, then return) -- the resume tests'
        preemption."""
        opt = self.opt
        if is_coordinator():
            os.makedirs(opt.exp_dir, exist_ok=True)
            # full config snapshot: every knob is machine-readable per run
            snap = {k: v for k, v in asdict(opt).items() if k != "ontology"}
            with open(os.path.join(opt.exp_dir, "config.json"), "w") as fp:
                json.dump(snap, fp, indent=1, default=str)
        logger = self.logger or (make_logger(
            os.path.join(opt.exp_dir, "log.train")) if is_coordinator()
            else _silent_logger())
        logger.info("Training starts at %s" % time.asctime())

        # SIGTERM requests a checkpoint at the next epoch boundary; resume
        # with `--resume auto`
        preempted = {"flag": False}
        try:
            import signal

            prev_handler = signal.signal(
                signal.SIGTERM,
                lambda *_: preempted.update(flag=True))
        except (ValueError, OSError):  # not the main thread
            prev_handler = None
        csv_name = "tod_asr_bert_stc"

        best = self._best or {"epoch": 0, "vf": 0.0, "tef": 0.0,
                              "v_acc": 0.0, "te_acc": 0.0}
        has_test = "test" in self.data
        start_epoch = self._start_epoch
        if start_epoch:
            logger.info("Resuming at epoch %02d (best valid F1 so far "
                        "%.2f @ epoch %02d)" %
                        (start_epoch, best["vf"], best["epoch"]))

        def stop(i) -> bool:
            """Checkpoint and stop after epoch i when asked to."""
            if stop_after_epoch is not None and i >= stop_after_epoch:
                preempted["flag"] = True
            if not preempted["flag"]:
                return False
            path = os.path.join(opt.exp_dir, f"ckpt_epoch{i}")
            self.save_checkpoint(path, epoch=i + 1, best=best)
            logger.info("SIGTERM: checkpointed to %s after epoch %02d; "
                        "resume with --resume auto" % (path, i))
            return True

        def periodic_checkpoint(i) -> None:
            if opt.checkpoint_every and (i + 1) % opt.checkpoint_every == 0:
                self.save_checkpoint(
                    os.path.join(opt.exp_dir, f"ckpt_epoch{i}"),
                    epoch=i + 1, best=best)

        # --profile_dir traces the epoch JAX traces (loop.py:655-662)
        profile_epoch = min(max(1, start_epoch), opt.max_epoch - 1)
        for i in range(start_epoch, opt.max_epoch):
            t0 = time.time()
            if opt.profile_dir and i == profile_epoch:
                from ..utils.profiling import trace

                with trace(opt.profile_dir, self.device):
                    tr = self.run_train_epoch()
            else:
                tr = self.run_train_epoch()
            logger.info(
                "[Train]\tEpoch: %02d\tTime: %.2f\tLoss: %.2f\t"
                "(p/r/f): (%.2f/%.2f/%.2f)\tAcc: %.2f" %
                (i, time.time() - t0, tr.mean_loss, tr.precision,
                 tr.recall, tr.f1, tr.acc))

            # --eval_every N: skip the valid/test evals on off-cycle
            # epochs (always evaluate the last)
            if (opt.eval_every > 1 and (i + 1) % opt.eval_every
                    and i != opt.max_epoch - 1):
                periodic_checkpoint(i)
                if stop(i):
                    break
                continue

            artifacts = opt.eval_artifacts != "none"
            t0 = time.time()
            vm, v_info = self.run_eval_epoch(
                "valid", i,
                dump_prefix=os.path.join(opt.exp_dir, f"valid.iter{i}")
                if artifacts else None)
            logger.info(
                "[Valid]\tEpoch: %02d\tTime: %.2f\tLoss: %.2f\t"
                "(p/r/f): (%.2f/%.2f/%.2f)\tAcc: %.2f" %
                (i, time.time() - t0, vm.mean_loss, vm.precision,
                 vm.recall, vm.f1, vm.acc))
            if artifacts and is_coordinator():
                observability_lens(v_info, i, "valid", opt.exp_dir,
                                   csv_name)

            tem = EpochMetrics(0, 0, 0, 0, 0)
            if has_test:
                t0 = time.time()
                tem, te_info = self.run_eval_epoch(
                    "test", i,
                    dump_prefix=os.path.join(opt.exp_dir, f"test.iter{i}")
                    if artifacts else None)
                logger.info(
                    "[Test]\tEpoch: %02d\tTime: %.2f\tLoss: %.2f\t"
                    "(p/r/f): (%.2f/%.2f/%.2f)\tAcc: %.2f" %
                    (i, time.time() - t0, tem.mean_loss, tem.precision,
                     tem.recall, tem.f1, tem.acc))
                if artifacts and is_coordinator():
                    observability_lens(te_info, i, "test", opt.exp_dir,
                                       csv_name)

            if vm.f1 > best["vf"]:
                best.update(epoch=i, vf=vm.f1, tef=tem.f1, v_acc=vm.acc,
                            te_acc=tem.acc)
                if opt.save_best != "none":
                    self.save_checkpoint(
                        os.path.join(opt.exp_dir, "model.ckpt"),
                        epoch=i + 1, best=best)
                logger.info(
                    "NEW BEST:\tEpoch: %02d\tvalid F1/Acc: %.2f/%.2f\t"
                    "test F1/Acc: %.2f/%.2f" %
                    (i, vm.f1, vm.acc, tem.f1, tem.acc))

            periodic_checkpoint(i)
            if stop(i):
                break

        logger.info(
            "BEST RESULT:\tEpoch: %02d\tBest valid F1/Acc: %.2f/%.2f\t"
            "test F1/Acc: %.2f/%.2f" %
            (best["epoch"], best["vf"], best["v_acc"], best["tef"],
             best["te_acc"]))
        if is_coordinator():
            with open(os.path.join(opt.exp_dir, "best.json"), "w") as fp:
                json.dump(best, fp)
        if prev_handler is not None:
            import signal

            signal.signal(signal.SIGTERM, prev_handler)
        return best

    def test(self) -> Dict[str, EpochMetrics]:
        """``--testing``: loads the best checkpoint and evaluates every
        split."""
        opt = self.opt
        logger = self.logger or (make_logger(
            os.path.join(opt.exp_dir, "log.test")) if is_coordinator()
            else _silent_logger())
        ckpt = os.path.join(opt.exp_dir, "model.ckpt")
        if os.path.exists(ckpt):
            self.load_checkpoint(ckpt)
        results = {}
        for split in self.buckets:  # in direct mode train has no buckets
            t0 = time.time()
            m, _ = self.run_eval_epoch(
                split, 0,
                dump_prefix=os.path.join(opt.exp_dir, f"{split}.eval"))
            logger.info(
                "[%s]\tTime: %.2f\tLoss: %.2f\t(p/r/f): "
                "(%.2f/%.2f/%.2f)\tAcc: %.2f" %
                (split.capitalize(), time.time() - t0, m.mean_loss,
                 m.precision, m.recall, m.f1, m.acc))
            results[split] = m
        return results


# --------------------------------------------------------------------- #
# model/config resolution
# --------------------------------------------------------------------- #

def build_model(opt: RunOptions, memory: Memory, tokenizer, device
                ) -> tuple[ModelConfig, dict]:
    """The model config and initial params, as JAX's ``build_model``
    resolves them (`n_best_asr_bert.py:33-37, 480-487`).

    A requested pretrained checkpoint -- ``--tod_pre_trained_model DIR``,
    or ``--pre_trained_model bert|roberta|xlm-roberta`` through
    ``HF_NAMES`` and ``resolve_checkpoint`` -- is read by
    ``models/hf_convert.load_pretrained_encoder`` with JAX's overrides
    (dropout from ``--bert_dropout``, the compute dtype, the kernel flags);
    one that fails to load raises ``RuntimeError`` under
    ``--require_pretrained`` and otherwise warns on stderr, with JAX's
    text, and the run trains from scratch.  From scratch, the tokenizer
    sizes the embedding; hidden 768, intermediate 3072 and at least 4
    heads, as JAX's.  The kernel flags' "auto" (None) means the
    hand-written kernels wherever the device is CUDA -- JAX's TPU rule --
    and the int8 training flags' "auto" means off on CUDA (the int8 step
    is slower than the bf16 one on the H100, PERF.md); explicit flags win.
    The params come from a ``torch.Generator`` seeded by ``random_seed``
    (a checkpoint's encoder replaces the drawn one), on ``device``."""
    from ..data.tokenizer import HF_NAMES, resolve_checkpoint
    from ..models.encoder import EncoderConfig
    from ..models.hf_convert import load_pretrained_encoder

    device = torch.device(device)

    def resolve_flash(flag):
        return device.type == "cuda" if flag is None else bool(flag)

    def resolve_int8(flag):
        return False if flag is None else bool(flag)

    common = dict(
        hidden_dropout=opt.bert_dropout, attn_dropout=opt.bert_dropout,
        compute_dtype=opt.compute_dtype,
        use_flash_attention=resolve_flash(opt.use_flash_attention),
        use_fused_ffn=resolve_flash(opt.use_fused_ffn),
        use_fused_attn=resolve_flash(opt.use_fused_attn),
        use_int8_train=resolve_int8(opt.int8_train),
        use_int8_train_attn=resolve_int8(opt.int8_train_attn),
        use_int8_train_bwd=resolve_int8(opt.int8_train_bwd),
        flash_min_seq=opt.flash_min_seq,
        remat=opt.remat)

    enc_cfg = enc_params = None
    name = opt.tod_pre_trained_model or HF_NAMES.get(
        opt.pre_trained_model or "")
    if name and not opt.tod_pre_trained_model:
        name = resolve_checkpoint(name)
    if name:
        try:
            enc_cfg, enc_params = load_pretrained_encoder(name, **common)
        except Exception as e:
            msg = (f"could not load pretrained encoder {name!r}: "
                   f"{type(e).__name__}: {e}")
            if opt.require_pretrained:
                raise RuntimeError(
                    msg + " (--require_pretrained set; refusing the "
                    "from-scratch fallback)") from e
            print(
                "WARNING: %s\nWARNING: training FROM SCRATCH — results "
                "will not be comparable to the pretrained benchmark. "
                "Pass --require_pretrained to make this fatal." % msg,
                file=sys.stderr, flush=True)
            enc_cfg = None

    if enc_cfg is None:
        enc_cfg = EncoderConfig(
            vocab_size=tokenizer.vocab_size,
            hidden_size=768,
            num_layers=opt.n_layers,
            num_heads=max(opt.n_head, 4),
            intermediate_size=3072,
            max_position=512,
            position_offset=0,
            **common)
    cfg = ModelConfig(encoder=enc_cfg, n_top=memory.n_top,
                      n_bottom=memory.n_bottom, head_dropout=opt.dropout)
    gen = torch.Generator().manual_seed(opt.random_seed)
    if enc_params is None:
        params = init_model_params(gen, cfg)
    else:       # no draws for an encoder the checkpoint replaces
        params = {"encoder": enc_params,
                  "head": init_head_params(gen, cfg.hidden, cfg.n_top,
                                           cfg.n_bottom)}
    return cfg, _tree_to(params, device)
