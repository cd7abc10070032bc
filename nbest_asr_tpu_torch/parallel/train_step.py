"""Train and eval steps on one device -- the port of
``nbest_asr_tpu/parallel/train_step.py`` (``make_train_step`` :123,
``make_eval_step`` :238) for ``data_mode="index"`` and
``steps_per_call=1``.

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
model folds per-stream, per-layer and per-site seeds out of it.

The TPU-only machinery stays behind: the mesh, direct data mode and step
chaining.  Parameters are updated functionally (a new tree per step), so
the caller keeps the old state; the f32 masters of BERT-base are 0.4 GB.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..models.model import ModelConfig, model_forward
from ..train.decode import decode_multihot
from ..train.losses import LossConfig, total_loss
from ..train.metrics import f1_counts_from_multihot
from ..train.optimizer import apply_updates, tree_leaves, tree_map


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


def _forward_and_loss(params, cfg: ModelConfig, loss_cfg: LossConfig,
                      hier, micro, *, deterministic: bool, seed,
                      dual_stream: bool):
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
        else None)
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
    loss, parts = total_loss(top, probs, final, labels, hier, loss_cfg,
                             asr_cls=asr_cls, trans_cls=trans_cls,
                             example_mask=row_mask)
    return loss, (parts, top, probs, labels, row_mask)


def _add(acc, new):
    return new if acc is None else tree_map(torch.add, acc, new)


def _unflatten(template, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def make_train_step(cfg: ModelConfig, loss_cfg: LossConfig, optimizer,
                    hier: Dict[str, torch.Tensor], *, n_accum: int = 1,
                    dual_stream: bool = True):
    """Returns ``train_step(state, data, idx, gen) -> (state, stats)``.

    - ``data``: dict of full-split tensors on the device (input_ids,
      attn_mask, segment_ids, trans_*, labels; packed splits add
      position_ids, cls_pos, seg_mask and their trans_* twins).
    - ``idx``: (n_accum, micro_b) row indices for this step.
    - ``gen``: the torch.Generator that seeds this step's dropout.
    - ``stats``: loss parts and F1 counters, summed over the micros, as
      device scalars."""

    def train_step(state: TrainState, data, idx, gen: torch.Generator):
        dev = next(iter(data.values())).device
        idx = torch.as_tensor(idx, device=dev).long()
        if idx.shape[0] != n_accum:
            raise ValueError(f"train_step: idx has {idx.shape[0]} micros, "
                             f"n_accum is {n_accum}")
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        params = _unflatten(state.params, leaves)
        grads = parts_acc = counts_acc = None
        for i in range(n_accum):
            micro = _gather_micro(data, idx[i])
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                     device=gen.device))
            loss, (parts, top, probs, labels, row_mask) = \
                _forward_and_loss(params, cfg, loss_cfg, hier, micro,
                                  deterministic=False, seed=seed,
                                  dual_stream=dual_stream)
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
        with torch.no_grad():
            updates, opt_state = optimizer.update(
                _unflatten(state.params, grads), state.opt_state,
                state.params)
            new_params = apply_updates(state.params, updates)
        return (TrainState(new_params, opt_state, state.step + 1),
                {"loss": parts_acc, "counts": counts_acc})

    return train_step


def make_eval_step(cfg: ModelConfig, loss_cfg: LossConfig,
                   hier: Dict[str, torch.Tensor], *,
                   dual_stream: bool = False):
    """Returns ``eval_step(params, data, idx) -> stats`` with the loss
    parts, the F1 counters, the decoded multi-hot ``pred`` and the top
    scores.  Eval never adds the MSE term (``train_step.py:249``)."""
    eval_loss_cfg = LossConfig(add_l2_loss=False)

    @torch.no_grad()
    def eval_step(params, data, idx):
        dev = next(iter(data.values())).device
        micro = _gather_micro(data, torch.as_tensor(idx, device=dev).long())
        _, (parts, top, probs, labels, row_mask) = _forward_and_loss(
            params, cfg, eval_loss_cfg, hier, micro, deterministic=True,
            seed=None, dual_stream=dual_stream)
        pred = decode_multihot(top, probs, hier)
        counts = f1_counts_from_multihot(pred, labels, row_mask)
        return {"loss": parts, "counts": counts, "pred": pred, "top": top}

    return eval_step
