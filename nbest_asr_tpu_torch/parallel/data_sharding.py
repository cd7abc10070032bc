"""Data-parallel batch splitting -- the counterpart of
``nbest_asr_tpu/parallel/data_sharding.py``.

JAX assembles global arrays from per-process shards
(``process_sharded_batch``); torch has no global arrays, so each
data-parallel rank simply computes on its own rows of every global
micro.  In index mode every rank holds the split and ``dp_rows`` takes its
contiguous slice of the micro's row indices (JAX's ``P(("dcn", "data"))``
places row blocks the same way); in direct mode
``parallel/process_data.ProcessTrainShard`` hands each rank its rows.
"""

from __future__ import annotations

import torch

from .mesh import Mesh


def global_batch_size(mesh: Mesh, per_device_batch: int) -> int:
    """Global microbatch rows for a given per-device batch."""
    return per_device_batch * mesh.dp_size


def local_batch_size(micro_b: int, process_count: int) -> int:
    """Rows of a global micro of ``micro_b`` rows on each of
    ``process_count`` data-parallel ranks."""
    if micro_b % process_count:
        raise ValueError(
            f"micro batch {micro_b} not divisible by process count "
            f"{process_count} (direct data mode shards the batch "
            "dim across processes)")
    return micro_b // process_count


def dp_rows(idx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of one global micro's row indices ``idx``
    (micro_b,): the dp rank's contiguous block of micro_b / dp rows."""
    lb = local_batch_size(idx.shape[0], mesh.dp_size)
    return idx[mesh.dp_rank * lb:(mesh.dp_rank + 1) * lb]
