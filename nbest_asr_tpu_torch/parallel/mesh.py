"""Process mesh and parameter sharding over ``torch.distributed`` -- the
port of ``nbest_asr_tpu/parallel/mesh.py`` (``make_mesh`` :39,
``dp_axes`` :62, ``_spec_for`` :67).

One process is one rank, one device.  The ranks form JAX's mesh, in JAX's
order: axes (dcn, data, model), model innermost, so rank = (dcn_i * n_data
+ data_i) * n_model + model_i.

- ``dcn`` and ``data`` split the batch.  The port flattens them into one
  data-parallel (dp) group: the gradient sum over dcn is the same sum
  (``tests/test_dp_invariance.py:144``), and one ``all_reduce`` over the
  flattened group is the cheapest layout on one host.
- ``model`` is tensor parallelism (tp) with the Megatron pairing of
  ``docs/SCALING.md:31-40``: QKV and W1 column-parallel on the local
  heads and columns, out-proj and W2 row-parallel, each followed by one
  ``all_reduce`` over the tp group (``reduce_from_tp``), and the
  conjugate ``copy_to_tp`` before each column-parallel product, whose
  backward sums the input's gradient over tp.  The word embedding is
  vocab-parallel.  Every other leaf is replicated.

``shard_params`` cuts a full parameter tree into this rank's leaves by
``_spec_for``'s rules and ``gather_params`` puts it back together, with
two differences from JAX's GSPMD layouts, which XLA may reshard freely
while a hand-written split may not:

- **QKV thirds.**  ``qkv_kernel`` (L, h, 3h) and ``qkv_bias`` (L, 3h)
  hold q | k | v.  ``P(None, None, "model")`` cuts the last axis into
  contiguous blocks, which at tp = 2 would give rank 0 all of q and half
  of k.  The port cuts each third by heads: rank r holds heads [r nh / T,
  (r + 1) nh / T) of q, of k and of v, laid out q_r | k_r | v_r, so its
  attention runs on whole local heads.  ``gather_params`` restores JAX's
  layout exactly.
- **Padded vocab.**  ``P("model", None)`` cuts the word table's rows into
  contiguous blocks; the port first pads the table with zero rows to a
  multiple of T (XLM-R's 250002 rows do not divide by 4).  An id at or
  past the vocab reads the last real row, which lives on the last shard,
  and trains nothing (``ops/layers.take_rows_shard``); the padding rows
  get no gradient and stay zero.  ``gather_params`` drops them.

Without a process group ``make_mesh`` gives the one-rank mesh, whose
groups are ``None``: every collective here is then skipped.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..train.optimizer import tree_map_with_path


def init_distributed(device) -> bool:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL for
    a CUDA ``device``, which becomes the current device, gloo for the CPU.
    Does nothing where a group is already initialised (a caller such as
    ``chip_smoke.py`` or a test may set up its own first).  Returns
    whether it initialised the group, which its caller then owns."""
    if dist.is_initialized():
        return False
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method="env://",
        rank=int(os.environ.get("RANK", "0")),
        world_size=int(os.environ.get("WORLD_SIZE", "1")), **kw)
    return True


def world_size() -> int:
    """Ranks of the initialised process group, else what torchrun's
    ``WORLD_SIZE`` says (1 without it)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_coordinator() -> bool:
    """Rank 0, or no process group: the one process that writes the
    run's artifacts (``train/loop.py``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (dcn, data, model) mesh and its two
    groups: ``dp_group`` over dcn x data (flattened), ``tp_group`` over
    model.  Both are ``None`` on the one-rank mesh without a process
    group."""

    n_dcn: int
    n_data: int
    n_model: int
    dp_rank: int
    tp_rank: int
    dp_group: Optional[object]
    tp_group: Optional[object]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (("dcn",) if self.n_dcn > 1 else ()) + ("data", "model")

    @property
    def dp_size(self) -> int:
        return self.n_dcn * self.n_data

    @property
    def tp_size(self) -> int:
        return self.n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              n_dcn: int = 1) -> Mesh:
    """The (dcn x) data x model mesh over every rank of the process group
    (one rank without one).  ``n_data`` defaults to what the world leaves
    after dcn and model.  Every rank makes every group, in one order, as
    ``new_group`` requires."""
    total = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = total // (n_model * n_dcn)
    if n_dcn * n_data * n_model != total:
        raise ValueError(f"mesh {n_dcn}x{n_data}x{n_model} does not cover "
                         f"the world of {total} ranks")
    if not dist.is_initialized():
        return Mesh(n_dcn, n_data, n_model, 0, 0, None, None)
    rank, n_dp = dist.get_rank(), n_dcn * n_data
    dp_group = tp_group = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_dp)])
        if rank % n_model == m:
            dp_group = g
    for d in range(n_dp):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            tp_group = g
    return Mesh(n_dcn, n_data, n_model, rank // n_model, rank % n_model,
                dp_group, tp_group)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes the batch dimension is split over."""
    return tuple(a for a in ("dcn", "data") if a in mesh.axis_names)


def _spec_for(path_str: str, ndim: int, tensor_parallel: bool) -> tuple:
    """JAX's partition rule for one parameter leaf, as a tuple (JAX's
    ``PartitionSpec`` is one): the axis that ``model`` splits, ``None``
    elsewhere; ``()`` for a replicated leaf."""
    if not tensor_parallel:
        return ()
    # stacked layer tensors carry a leading (num_layers,) axis
    if "qkv_kernel" in path_str:        # (L, h, 3h) -- split heads
        return (None, None, "model")
    if "qkv_bias" in path_str:          # (L, 3h)
        return (None, "model")
    if "attn_out_kernel" in path_str:   # (L, h, h) -- split contracting dim
        return (None, "model", None)
    if "ffn_in_kernel" in path_str:     # (L, h, i)
        return (None, None, "model")
    if "ffn_in_bias" in path_str:       # (L, i)
        return (None, "model")
    if "ffn_out_kernel" in path_str:    # (L, i, h)
        return (None, "model", None)
    if "embeddings/word" in path_str:   # (V, h) -- shard vocab rows
        return ("model", None)
    return ()


def shard_leaf(path: str, x: torch.Tensor, n: int, r: int) -> torch.Tensor:
    """Rank r's part of the full leaf ``x`` at ``path`` under tp = n (the
    module docstring's layout)."""
    spec = _spec_for(path, x.dim(), n > 1)
    if "model" not in spec:
        return x
    axis = spec.index("model")
    if "qkv" in path:
        thirds = x.unflatten(axis, (3, x.shape[axis] // 3))
        return thirds.chunk(n, dim=axis + 1)[r].flatten(
            axis, axis + 1).contiguous()
    if "embeddings/word" in path:
        pad = -x.shape[0] % n
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad else x
    return x.chunk(n, dim=axis)[r].contiguous()


def unshard_leaf(path: str, parts, vocab_size: int) -> torch.Tensor:
    """The full leaf from the n ranks' ``parts`` (``shard_leaf``'s
    inverse); the word table is cut back to ``vocab_size`` rows."""
    n = len(parts)
    spec = _spec_for(path, parts[0].dim(), n > 1)
    if "model" not in spec:
        return parts[0]
    axis = spec.index("model")
    if "qkv" in path:
        return torch.cat([p.unflatten(axis, (3, p.shape[axis] // 3))
                          for p in parts], dim=axis + 1).flatten(
                              axis, axis + 1)
    full = torch.cat(parts, dim=axis)
    return full[:vocab_size] if "embeddings/word" in path else full


def shard_params(params: dict, mesh: Mesh) -> dict:
    """The full tree ``params`` (a parameter tree or an optimizer moment
    of one) -> this rank's leaves."""
    return tree_map_with_path(
        lambda p, x: shard_leaf(p, x, mesh.tp_size, mesh.tp_rank), params)


def gather_params(params: dict, mesh: Mesh, vocab_size: int) -> dict:
    """This rank's leaves -> the full tree, on every rank of its tp
    group (one ``all_gather`` per sharded leaf; a collective: every rank
    of the group calls it)."""
    if mesh.tp_size == 1:
        return params

    def one(path, x):
        if "model" not in _spec_for(path, x.dim(), True):
            return x
        parts = [torch.empty_like(x) for _ in range(mesh.tp_size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.tp_group)
        return unshard_leaf(path, parts, vocab_size)

    return tree_map_with_path(one, params)


def is_tp_sharded(path: str, mesh: Optional[Mesh]) -> bool:
    """Whether tp splits the leaf at ``path`` on ``mesh``."""
    return (mesh is not None and mesh.tp_size > 1
            and "model" in _spec_for(path, 0, True))


# --------------------------------------------------------------------- #
# the Megatron pairing's two conjugate collectives
# --------------------------------------------------------------------- #

def _all_reduce_acc(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, reduced in at least f32 and
    returned in x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = x.to(acc, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over tp."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_acc(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over tp forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_acc(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a column-parallel product (Megatron's f)."""
    return _CopyToTP.apply(x, mesh.tp_group)


def reduce_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The output of a row-parallel product (Megatron's g): one
    ``all_reduce`` over tp."""
    return _ReduceFromTP.apply(x, mesh.tp_group)
