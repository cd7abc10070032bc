"""Optimizers on nested dicts of tensors -- the port of
``nbest_asr_tpu/train/optimizer.py``: BertAdam, plus the adam and adamw
parity modes, each a ``GradientTransformation`` (``init``, ``update``)
as optax's, in plain torch (no ``torch.optim``).

- ``bert_adam`` (:140): Adam without bias correction, a per-tensor
  gradient-norm clip whose granularity is the reference's parameter set
  (per layer of a stacked (L, ...) leaf, per q/k/v third of the fused QKV
  leaves), decoupled weight decay added before the lr scaling, and a
  schedule evaluated at the pre-increment step (step 0 trains at lr 0).
- ``lr_tree`` / ``wd_tree``: ``bert_lr`` for encoder leaves, ``lr`` for
  the head; weight decay except on bias and LayerNorm leaves.
- ``adam``: global-norm clip, L2 into the gradients, bias-corrected Adam
  (eps 1e-8); ``adamw``: the clip, then HF AdamW(correct_bias=False) with
  a linear warmup / decay schedule.
- ``freeze_encoder``: encoder gradients and updates are zeroed.
- ``mesh`` (``parallel/mesh.py``): on a leaf that tensor parallelism
  shards, each clip's squared norm is summed over the tp group before the
  scale is taken (GSPMD does this sum in JAX), so tp = 2 clips by the
  whole tensor's norm and not each shard by its own.

The step count lives on the host as a Python int, so the schedule costs
no device sync; the schedule arithmetic runs in float32 as JAX's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]


# --------------------------------------------------------------------- #
# trees (nested dicts) and schedules
# --------------------------------------------------------------------- #

def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, _path: Tuple = ()):
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      _path=_path + (k,))
                for k, v in tree.items()}
    return fn("/".join(_path), tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _f32(x) -> np.float32:
    return np.float32(x)


def warmup_linear(warmup: float) -> Callable:
    w = _f32(warmup)

    def f(progress):
        if progress < w:
            return _f32(progress / w)
        return _f32(max(_f32(progress - _f32(1.0)) / _f32(w - _f32(1.0)),
                        _f32(0.0)))
    return f


def warmup_constant(warmup: float) -> Callable:
    w = _f32(warmup)
    return lambda progress: _f32(progress / w) if progress < w else _f32(1)


def warmup_cosine(warmup: float, cycles: float = 0.5) -> Callable:
    w = _f32(warmup)

    def f(progress):
        if progress < w:
            return _f32(progress / w)
        rest = _f32(progress - w) / _f32(max(_f32(1.0) - w, _f32(1e-9)))
        return _f32(0.5 * (1.0 + np.cos(np.float32(np.pi) * _f32(cycles)
                                         * _f32(2.0) * rest)))
    return f


def constant_schedule() -> Callable:
    return lambda progress: _f32(1.0)


SCHEDULES = {None: constant_schedule, "none": constant_schedule,
             "warmup_linear": warmup_linear,
             "warmup_constant": warmup_constant,
             "warmup_cosine": warmup_cosine}


# --------------------------------------------------------------------- #
# config + tree labelling
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class OptimizerConfig:
    """Same fields and defaults as the JAX ``OptimizerConfig``."""

    optim_choice: str = "bertadam"     # bertadam | adam | adamw
    lr: float = 5e-4                   # head lr
    bert_lr: float = 1e-5              # encoder lr
    warmup_proportion: float = 0.1
    t_total: int = -1                  # total optimizer steps
    schedule: str = "warmup_linear"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    l2: float = 0.0
    freeze_encoder: bool = False


def is_encoder_leaf(path: str) -> bool:
    return path.startswith("encoder")


def is_no_decay_leaf(path: str) -> bool:
    return "bias" in path or "ln_scale" in path or "ln_bias" in path


def lr_tree(params: Tree, cfg: OptimizerConfig) -> Tree:
    return tree_map_with_path(
        lambda p, x: cfg.bert_lr if is_encoder_leaf(p) else cfg.lr, params)


def wd_tree(params: Tree, cfg: OptimizerConfig) -> Tree:
    return tree_map_with_path(
        lambda p, x: 0.0 if is_no_decay_leaf(p) else cfg.weight_decay,
        params)


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _zeros(params: Tree) -> Tree:
    return tree_map(torch.zeros_like, params)


# --------------------------------------------------------------------- #
# BertAdam
# --------------------------------------------------------------------- #

class BertAdamState(NamedTuple):
    step: int
    m: Tree
    v: Tree


def _tp_sums(params_template: Tree, mesh) -> Tree:
    """Per leaf: the function that sums a partial squared norm over the
    tp group where tp shards the leaf, else None."""
    from ..parallel.mesh import is_tp_sharded

    def one(path, x):
        if not is_tp_sharded(path, mesh):
            return None

        def tp_sum(sq):
            torch.distributed.all_reduce(sq, group=mesh.tp_group)
            return sq
        return tp_sum

    return tree_map_with_path(one, params_template)


def _clip_one(path: str, g: torch.Tensor, max_norm: float,
              tp_sum: Optional[Callable] = None) -> torch.Tensor:
    """Per-reference-tensor clip: per layer of a stacked leaf, per q/k/v
    third of the fused QKV leaves, whole otherwise (optimizer.py:162);
    ``tp_sum`` completes a sharded leaf's squared norms."""
    if max_norm <= 0:
        return g
    g32 = g.to(torch.promote_types(g.dtype, torch.float32))

    def scaled(x, dims):
        sq = (x * x).sum(dim=dims, keepdim=True)
        norm = torch.sqrt(sq if tp_sum is None else tp_sum(sq))
        return x * torch.clamp(max_norm / (norm + 1e-6), max=1.0)

    if "layers/" in path:
        if "qkv" in path:
            chunks = torch.stack(torch.chunk(g32, 3, dim=-1), dim=1)
            chunks = scaled(chunks, tuple(range(2, chunks.dim())))
            g32 = torch.cat(chunks.unbind(1), dim=-1)
        else:
            g32 = scaled(g32, tuple(range(1, g32.dim())))
    else:
        g32 = scaled(g32, tuple(range(g32.dim())))
    return g32.to(g.dtype)


def bert_adam(cfg: OptimizerConfig, params_template: Tree, mesh=None
              ) -> GradientTransformation:
    lrs = lr_tree(params_template, cfg)
    wds = wd_tree(params_template, cfg)
    tp_sums = _tp_sums(params_template, mesh)
    sched = SCHEDULES[cfg.schedule](cfg.warmup_proportion) \
        if cfg.schedule not in (None, "none") else constant_schedule()

    def init_fn(params):
        return BertAdamState(step=0, m=_zeros(params), v=_zeros(params))

    def update_fn(grads, state, params):
        if cfg.t_total > 0:
            mult = sched(_f32(state.step) / _f32(cfg.t_total))
        else:
            mult = _f32(1.0)
        grads = tree_map_with_path(
            lambda p, g, t: _clip_one(p, g, cfg.max_grad_norm, t), grads,
            tp_sums)
        new_m = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g,
                         state.m, grads)
        new_v = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g,
                         state.v, grads)

        def upd(m, v, p, lr, wd):
            u = m / (torch.sqrt(v) + cfg.eps)
            u = u + wd * p
            return u * float(-(_f32(lr) * mult))

        updates = tree_map(upd, new_m, new_v, params, lrs, wds)
        return updates, BertAdamState(step=state.step + 1, m=new_m, v=new_v)

    return GradientTransformation(init_fn, update_fn)


# --------------------------------------------------------------------- #
# adam / adamw parity modes
# --------------------------------------------------------------------- #

class AdamState(NamedTuple):
    step: int
    m: Tree
    v: Tree


def _global_norm_clip(grads: Tree, max_norm: float,
                      tp_sums: Optional[Tree] = None) -> Tree:
    """optax.clip_by_global_norm: unchanged below the norm, else
    (g / norm) * max_norm.  The squares of the leaves that ``tp_sums``
    marks are summed over tp once."""
    if max_norm <= 0:
        return grads
    marks = tree_leaves(tp_sums) if tp_sums is not None else \
        [None] * len(tree_leaves(grads))
    pairs = list(zip(tree_leaves(grads), marks))
    sq = sum((g.to(torch.float32) ** 2).sum() for g, t in pairs if t is None)
    sharded = [g for g, t in pairs if t is not None]
    if sharded:
        sq = sq + next(t for _, t in pairs if t is not None)(
            sum((g.to(torch.float32) ** 2).sum() for g in sharded))
    norm = torch.sqrt(sq)
    keep = norm < max_norm
    return tree_map(lambda g: torch.where(keep, g, (g / norm.to(g.dtype))
                                          * max_norm), grads)


def _moments(grads, state, cfg: OptimizerConfig):
    new_m = tree_map(lambda m, g: (1 - cfg.b1) * g + cfg.b1 * m, state.m,
                     grads)
    new_v = tree_map(lambda v, g: (1 - cfg.b2) * (g * g) + cfg.b2 * v,
                     state.v, grads)
    return new_m, new_v


def _plain_adam(cfg: OptimizerConfig, tp_sums: Optional[Tree] = None
                ) -> GradientTransformation:
    """torch.optim.Adam(lr, betas, eps=1e-8, weight_decay=l2) after the
    global-norm clip (optax: clip, add_decayed_weights, scale_by_adam,
    scale(-lr))."""

    def init_fn(params):
        return AdamState(step=0, m=_zeros(params), v=_zeros(params))

    def update_fn(grads, state, params):
        grads = _global_norm_clip(grads, cfg.max_grad_norm, tp_sums)
        if cfg.l2 > 0:
            grads = tree_map(lambda g, p: g + cfg.l2 * p, grads, params)
        m, v = _moments(grads, state, cfg)
        count = state.step + 1
        c1 = float(1 - _f32(cfg.b1) ** count)
        c2 = float(1 - _f32(cfg.b2) ** count)
        updates = tree_map(
            lambda mm, vv: (mm / c1) / (torch.sqrt(vv / c2) + 1e-8)
            * -cfg.lr, m, v)
        return updates, AdamState(step=count, m=m, v=v)

    return GradientTransformation(init_fn, update_fn)


def _adamw(cfg: OptimizerConfig, params_template: Tree,
           tp_sums: Optional[Tree] = None) -> GradientTransformation:
    """HF AdamW(correct_bias=False) + get_linear_schedule_with_warmup,
    grouped lrs / wd, after the global-norm clip."""
    lrs = lr_tree(params_template, cfg)
    wds = wd_tree(params_template, cfg)
    warmup_steps = int(cfg.warmup_proportion * max(cfg.t_total, 1))

    def lr_mult(step: int) -> np.float32:
        s = _f32(step)
        if s < warmup_steps:
            return _f32(s / _f32(max(1.0, warmup_steps)))
        return _f32(max(_f32(0.0), _f32(cfg.t_total - s)
                        / _f32(max(1.0, cfg.t_total - warmup_steps))))

    def init_fn(params):
        return AdamState(step=0, m=_zeros(params), v=_zeros(params))

    def update_fn(grads, state, params):
        grads = _global_norm_clip(grads, cfg.max_grad_norm, tp_sums)
        mult = lr_mult(state.step)
        m, v = _moments(grads, state, cfg)

        def upd(mm, vv, p, lr, wd):
            u = mm / (torch.sqrt(vv) + 1e-8)
            return (u + wd * p) * float(-(_f32(lr) * mult))

        updates = tree_map(upd, m, v, params, lrs, wds)
        return updates, AdamState(step=state.step + 1, m=m, v=v)

    return GradientTransformation(init_fn, update_fn)


def make_optimizer(cfg: OptimizerConfig, params_template: Tree,
                   mesh=None) -> GradientTransformation:
    """``params_template``: the tree the optimizer updates (this rank's
    shards under tensor parallelism, with ``mesh``)."""
    if cfg.optim_choice == "bertadam":
        tx = bert_adam(cfg, params_template, mesh)
    elif cfg.optim_choice == "adam":
        tx = _plain_adam(cfg, _tp_sums(params_template, mesh))
    elif cfg.optim_choice == "adamw":
        tx = _adamw(cfg, params_template, _tp_sums(params_template, mesh))
    else:
        raise ValueError(f"unknown optim_choice: {cfg.optim_choice}")
    if cfg.freeze_encoder:
        tx = _freeze_encoder_leaves(tx, params_template)
    return tx


def _freeze_encoder_leaves(tx: GradientTransformation, params_template: Tree
                           ) -> GradientTransformation:
    """Zero encoder gradients before ``tx`` and encoder updates after it
    (``optimizer.py:298``): frozen leaves stay bit-identical, momenta stay
    0, and the global-norm clip sees only trainable gradients."""
    mask = tree_map_with_path(
        lambda p, x: 0.0 if is_encoder_leaf(p) else 1.0, params_template)

    def update_fn(grads, state, params):
        grads = tree_map(lambda g, m: g * m, grads, mask)
        updates, state = tx.update(grads, state, params)
        return tree_map(lambda u, m: u * m, updates, mask), state

    return GradientTransformation(tx.init, update_fn)
