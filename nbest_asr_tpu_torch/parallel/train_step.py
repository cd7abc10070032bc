"""Train and eval steps -- the port of
``nbest_asr_tpu/parallel/train_step.py`` (``make_train_step`` :123,
``make_eval_step`` :238) for ``steps_per_call=1``, on one device or
over a process mesh (``parallel/mesh.py``).

The split lives on the device; each step receives an (n_accum, micro_b)
index array and gathers its microbatches there (index == n_rows is the
padding sentinel: the gather clamps it onto the last row and the derived
``example_mask`` zeroes that row out of the loss and metrics).  Per-micro
gradients are **summed** over ``n_accum`` micros (the losses are
sum-reduced, as the reference's ``.backward()`` accumulates) and the
optimizer steps once.  Decode and F1 counters come from the training
forward.  Packed micros (``cls_pos`` present, ``data/packing.py``) give
one output row per packed segment.

Dropout seeds: every micro draws one seed from the caller's explicit
``torch.Generator`` (a CPU generator draws without a device sync); the
model folds per-stream, per-layer and per-site seeds out of it.  With
more than one data-parallel rank each folds its dp index into the micro
seed, so that no two ranks draw one mask for different rows.

Over a mesh (JAX's ``mesh`` argument; torch has no global arrays, so
each rank computes on its own rows):

- ``data_mode="index"``: every rank holds the split and takes its dp
  rows of each global micro (``data_sharding.dp_rows``);
  ``data_mode="direct"``: ``data`` is this rank's micro stacks (n_accum,
  local_b, ...) with their ``example_mask``
  (``process_data.ProcessTrainShard.local_batch``), and ``idx`` is
  ignored;
- after the accumulation loop the summed gradients take one
  ``all_reduce(SUM)`` over the dp group, flattened into a few buffers
  (``all_reduce_grads``); the losses are sum-reduced, so the step is
  dp-invariant (``tests/test_dp_invariance.py:1-4``) -- all but the
  optional MSE, a mean over the micro's rows, whose row count each micro
  sums over dp first; the loss parts and the F1 counters take one more
  ``all_reduce``, so every rank returns the global numbers;
- tp > 1 runs the model tensor-parallel on this rank's shards
  (``models/encoder.py``); the optimizer completes the clip norms over tp.

Eval runs the whole micro on every rank, so every rank returns the full
batch's ``pred`` and ``top`` (JAX's ``gather_out``, :255-269) with no
collective beyond tp's.  Step chaining stays behind (TPU-only).
Parameters are updated functionally (a new tree per step), so the caller
keeps the old state; the f32 masters of BERT-base are 0.4 GB.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.distributed as dist

from ..models.model import ModelConfig, model_forward
from ..ops.philox import fold_in
from ..train.decode import decode_multihot
from ..train.losses import LossConfig, total_loss
from ..train.metrics import f1_counts_from_multihot
from ..train.optimizer import apply_updates, tree_leaves, tree_map
from .data_sharding import dp_rows

# elements per flattened all_reduce buffer (128 MB of f32)
BUCKET_NUMEL = 2 ** 25


class TrainState(NamedTuple):
    params: dict
    opt_state: Any
    step: int


def _gather_micro(data: Dict[str, torch.Tensor], idx: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    n_rows = next(iter(data.values())).shape[0]
    rows = idx.clamp(max=n_rows - 1)
    micro = {k: v.index_select(0, rows) for k, v in data.items()}
    micro["example_mask"] = (idx < n_rows).to(torch.float32)
    return micro


def all_reduce_grads(grads: list, group) -> None:
    """Sum the tensors ``grads`` over ``group`` in place, flattened into
    buffers of at most ``BUCKET_NUMEL`` elements: one ``all_reduce`` a
    buffer, not one a leaf."""
    i = 0
    while i < len(grads):
        j, n = i, 0
        while j < len(grads) and (j == i or n + grads[j].numel()
                                  <= BUCKET_NUMEL):
            n += grads[j].numel()
            j += 1
        flat = torch.cat([g.reshape(-1) for g in grads[i:j]])
        dist.all_reduce(flat, group=group)
        for g, part in zip(grads[i:j], flat.split(
                [g.numel() for g in grads[i:j]])):
            g.copy_(part.view_as(g))
        i = j


def _all_reduce_stats(stats: dict, group) -> dict:
    """The loss parts and F1 counters (dicts of scalars) summed over
    ``group`` in one ``all_reduce``."""
    keys = [(k, kk) for k in stats for kk in stats[k]]
    flat = torch.stack([stats[k][kk].to(torch.float32) for k, kk in keys])
    dist.all_reduce(flat, group=group)
    out = {k: {} for k in stats}
    for (k, kk), v in zip(keys, flat.unbind()):
        out[k][kk] = v
    return out


def _forward_and_loss(params, cfg: ModelConfig, loss_cfg: LossConfig,
                      hier, micro, *, deterministic: bool, seed,
                      dual_stream: bool, mesh=None):
    """-> loss, (parts, top, probs, labels, row_mask); ``labels`` and
    ``row_mask`` are per utterance (flattened per packed segment)."""
    packed = "cls_pos" in micro
    top, probs, final, asr_cls, trans_cls = model_forward(
        params, cfg, hier, micro["input_ids"], micro["attn_mask"],
        micro.get("segment_ids"),
        trans_input_ids=micro["trans_input_ids"] if dual_stream else None,
        trans_attn_mask=micro.get("trans_attn_mask") if dual_stream
        else None,
        trans_token_type_ids=micro.get("trans_segment_ids") if dual_stream
        else None,
        deterministic=deterministic, seed=seed,
        position_ids=micro.get("position_ids"),
        trans_position_ids=micro.get("trans_position_ids") if dual_stream
        else None,
        cls_positions=micro.get("cls_pos"),
        trans_cls_positions=micro.get("trans_cls_pos") if dual_stream
        else None, mesh=mesh)
    if packed:
        labels = micro["labels"].reshape(-1, micro["labels"].shape[-1])
        row_mask = micro["seg_mask"]
        em = micro.get("example_mask")
        if em is not None:
            row_mask = row_mask * em[:, None]
        row_mask = row_mask.reshape(-1)
    else:
        labels = micro["labels"]
        row_mask = micro.get("example_mask")
    mse_rows = None
    if (loss_cfg.add_l2_loss and trans_cls is not None and mesh is not None
            and mesh.dp_size > 1 and mesh.dp_group is not None):
        # the MSE averages over the global micro's rows: count them over dp
        mse_rows = (row_mask.sum() if row_mask is not None else
                    torch.tensor(float(labels.shape[0]),
                                 device=labels.device)).to(torch.float32)
        dist.all_reduce(mse_rows, group=mesh.dp_group)
    loss, parts = total_loss(top, probs, final, labels, hier, loss_cfg,
                             asr_cls=asr_cls, trans_cls=trans_cls,
                             example_mask=row_mask, mse_rows=mse_rows)
    return loss, (parts, top, probs, labels, row_mask)


def _add(acc, new):
    return new if acc is None else tree_map(torch.add, acc, new)


def _unflatten(template, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def make_train_step(cfg: ModelConfig, loss_cfg: LossConfig, optimizer,
                    hier: Dict[str, torch.Tensor], *, n_accum: int = 1,
                    dual_stream: bool = True, mesh=None,
                    data_mode: str = "index"):
    """Returns ``train_step(state, data, idx, gen) -> (state, stats)``.

    - ``data``: dict of full-split tensors on the device (input_ids,
      attn_mask, segment_ids, trans_*, labels; packed splits add
      position_ids, cls_pos, seg_mask and their trans_* twins); with
      ``data_mode="direct"`` this rank's micro stacks (module docstring).
    - ``idx``: (n_accum, micro_b) row indices of the global micros
      (``None`` in direct mode).
    - ``gen``: the torch.Generator that seeds this step's dropout.
    - ``stats``: loss parts and F1 counters, summed over the micros (and
      the dp ranks), as device scalars.
    - ``mesh``: the process mesh (``parallel/mesh.py``), ``None`` on one
      device; the optimizer must be made with the same mesh."""
    if data_mode not in ("index", "direct"):
        raise ValueError(f"data_mode {data_mode!r}: 'index' or 'direct'")
    dp = mesh is not None and mesh.dp_group is not None

    def train_step(state: TrainState, data, idx, gen: torch.Generator):
        dev = next(iter(data.values())).device
        if data_mode == "index":
            idx = torch.as_tensor(idx, device=dev).long()
            n_micros = idx.shape[0]
        else:
            n_micros = next(iter(data.values())).shape[0]
        if n_micros != n_accum:
            raise ValueError(f"train_step: {n_micros} micros, n_accum is "
                             f"{n_accum}")
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        params = _unflatten(state.params, leaves)
        grads = parts_acc = counts_acc = None
        for i in range(n_accum):
            if data_mode == "index":
                micro = _gather_micro(
                    data, dp_rows(idx[i], mesh) if mesh is not None
                    else idx[i])
            else:
                micro = {k: v[i] for k, v in data.items()}
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                     device=gen.device))
            if mesh is not None and mesh.dp_size > 1:
                seed = fold_in(seed, mesh.dp_rank)
            loss, (parts, top, probs, labels, row_mask) = \
                _forward_and_loss(params, cfg, loss_cfg, hier, micro,
                                  deterministic=False, seed=seed,
                                  dual_stream=dual_stream, mesh=mesh)
            g = [torch.zeros_like(p) if d is None else d for p, d in zip(
                leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
            grads = g if grads is None else \
                [a.add_(b) for a, b in zip(grads, g)]
            with torch.no_grad():
                pred = decode_multihot(top, probs, hier)
                counts = f1_counts_from_multihot(pred, labels, row_mask)
            parts_acc = _add(parts_acc, {k: v.detach()
                                         for k, v in parts.items()})
            counts_acc = _add(counts_acc, counts)
        stats = {"loss": parts_acc, "counts": counts_acc}
        if dp:
            all_reduce_grads(grads, mesh.dp_group)
            stats = _all_reduce_stats(stats, mesh.dp_group)
        with torch.no_grad():
            updates, opt_state = optimizer.update(
                _unflatten(state.params, grads), state.opt_state,
                state.params)
            new_params = apply_updates(state.params, updates)
        return TrainState(new_params, opt_state, state.step + 1), stats

    return train_step


def make_eval_step(cfg: ModelConfig, loss_cfg: LossConfig,
                   hier: Dict[str, torch.Tensor], *,
                   dual_stream: bool = False, mesh=None):
    """Returns ``eval_step(params, data, idx) -> stats`` with the loss
    parts, the F1 counters, the decoded multi-hot ``pred`` and the top
    scores, of the whole micro on every rank (``mesh``: tensor-parallel
    forward).  Eval never adds the MSE term (``train_step.py:249``)."""
    eval_loss_cfg = LossConfig(add_l2_loss=False)

    @torch.no_grad()
    def eval_step(params, data, idx):
        dev = next(iter(data.values())).device
        micro = _gather_micro(data, torch.as_tensor(idx, device=dev).long())
        _, (parts, top, probs, labels, row_mask) = _forward_and_loss(
            params, cfg, eval_loss_cfg, hier, micro, deterministic=True,
            seed=None, dual_stream=dual_stream, mesh=mesh)
        pred = decode_multihot(top, probs, hier)
        counts = f1_counts_from_multihot(pred, labels, row_mask)
        return {"loss": parts, "counts": counts, "pred": pred, "top": top}

    return eval_step
