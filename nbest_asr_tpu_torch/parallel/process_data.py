"""Per-process train-split shard: the host side of ``--data_mode
direct`` -- a trimmed copy of ``nbest_asr_tpu/parallel/process_data.py``
(``ProcessTrainShard`` :60, ``epoch_plan`` :112, ``local_batch`` :162),
numpy only, on the port's ``data/bucketing.py``.

Each data-parallel rank owns a strided subset of the rows of every length
bucket and trains on its slice of every global microbatch; no rank holds
the whole split.  The ranks agree on the plan without communicating,
because everything it depends on is global metadata or a shared seed:

- **bucket assignment** is a pure function of the global per-row lengths;
- **ownership** is strided within each bucket: rank ``p`` of ``P`` owns
  ``bucket_rows[p::P]`` (sizes differ by at most 1);
- **the shuffle** draws one global permutation per bucket from the shared
  seeded RNG; each rank takes its owned rows in global-shuffle order, so
  every rank consumes the RNG identically and agrees on the per-bucket
  step counts.  With one process the plan equals the index-mode
  Trainer's (``tests/test_direct_data.py:123``).

Sentinel slots (a bucket shard rarely divides the local batch) clamp onto
the last owned row and are masked out of the loss and metrics by
``example_mask``, as index mode's sentinel gather.

A rank's global micro is its ``local_b`` rows of each micro; with P > 1
the rows that form one global micro therefore differ from a single
process's (JAX's layout), and a bucket that takes more than one micro
trains on other row groups than index mode does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np

from ..data.bucketing import bucket_assignment, row_lengths, slice_rows
from .data_sharding import local_batch_size


@dataclass
class _ShardBucket:
    blen: int                     # bucket sequence length
    global_n: int                 # bucket rows across all ranks
    owned_pos: np.ndarray         # positions of owned rows in the bucket
    data: Dict[str, np.ndarray]   # owned rows, token streams cut to blen

    @property
    def local_n(self) -> int:
        return len(self.owned_pos)


class ProcessTrainShard:
    """This rank's share of the train split plus the global plan metadata
    needed to agree with every other rank."""

    def __init__(self, data: Dict[str, np.ndarray],
                 bucket_lens: List[int], *, process_index: int = 0,
                 process_count: int = 1):
        assert 0 <= process_index < process_count
        self.process_index = process_index
        self.process_count = process_count
        row_len = row_lengths(data)
        max_len = int(data["input_ids"].shape[1])
        if not bucket_lens:
            bucket_lens = [max_len]
        assignment = bucket_assignment(row_len, bucket_lens, max_len)
        owned_per_bucket = [
            rows[process_index::process_count] for _, rows in assignment]
        # global ids this rank owns, ascending
        self.owned_rows = np.sort(np.concatenate(owned_per_bucket)) \
            if owned_per_bucket else np.zeros((0,), np.int64)
        self.buckets: List[_ShardBucket] = []
        for (blen, rows), owned in zip(assignment, owned_per_bucket):
            self.buckets.append(_ShardBucket(
                blen=blen, global_n=len(rows),
                owned_pos=np.arange(len(rows))[process_index::process_count],
                data=slice_rows(data, owned, blen)))

    def local_batch_size(self, micro_b: int) -> int:
        return local_batch_size(micro_b, self.process_count)

    def epoch_plan(self, shuffle_rng: np.random.RandomState,
                   micro_b_for: Callable[[int], int], n_accum: int
                   ) -> List[Tuple[int, int, np.ndarray]]:
        """One epoch's per-bucket step plans: ``[(bucket_id, micro_b,
        idx), ...]`` with ``idx`` of shape (n_steps, n_accum, local_b),
        indices into this rank's owned rows, the sentinel ``local_n``
        marking padding slots.  Consumes ``shuffle_rng`` identically on
        every rank (one permutation of the global bucket size per
        bucket)."""
        plans = []
        for bi, b in enumerate(self.buckets):
            micro_b = micro_b_for(b.blen)
            local_b = self.local_batch_size(micro_b)
            perm = shuffle_rng.permutation(b.global_n)
            # micro count from the global size: every rank's shard fits
            n_micro = -(-b.global_n // micro_b)
            n_steps = n_micro // n_accum
            if n_steps == 0:
                continue  # bucket smaller than one accumulation group
            own = np.zeros(b.global_n, dtype=bool)
            own[b.owned_pos] = True
            seq = perm[own[perm]]            # owned, in shuffle order
            pos2local = np.full(b.global_n, -1, dtype=np.int64)
            pos2local[b.owned_pos] = np.arange(b.local_n)
            seq_local = pos2local[seq]
            padded = np.full((n_micro * local_b,), b.local_n,
                             dtype=np.int32)
            padded[:min(b.local_n, padded.size)] = \
                seq_local[:padded.size].astype(np.int32)
            idx = padded[: n_steps * n_accum * local_b].reshape(
                n_steps, n_accum, local_b)
            plans.append((bi, micro_b, idx))
        return plans

    def steps_per_epoch(self, micro_b_for: Callable[[int], int],
                        n_accum: int) -> int:
        """Optimizer steps one epoch takes (shuffle-independent)."""
        steps = 0
        for b in self.buckets:
            n_micro = -(-b.global_n // micro_b_for(b.blen))
            steps += n_micro // n_accum
        return steps

    def local_batch(self, bucket_id: int, idx: np.ndarray
                    ) -> Dict[str, np.ndarray]:
        """This rank's host stacks for one step: ``idx`` of shape (...,
        local_b) -> streams of shape (..., local_b, feat...) plus
        ``example_mask``.  Sentinel rows clamp onto the last owned row and
        mask to 0."""
        b = self.buckets[bucket_id]
        clamped = np.minimum(idx, max(b.local_n - 1, 0))
        out = {k: np.ascontiguousarray(v[clamped])
               for k, v in b.data.items()}
        out["example_mask"] = (idx < b.local_n).astype(np.float32)
        return out
