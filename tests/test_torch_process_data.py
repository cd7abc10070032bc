"""The port's ``parallel/process_data.ProcessTrainShard`` (the direct
data mode's per-rank shard) against the JAX package's, bit for bit, for
P = 1 to 4 ranks: ownership, bucket geometry, the epoch plans and the
shuffle RNG they consume, and ``local_batch``; with the properties of
``tests/test_direct_data.py:67-170`` -- disjoint and complete ownership,
every row trained at most once an epoch, the same plan geometry on every
rank, and with one process the index-mode Trainer's plan."""

import numpy as np
import pytest

from nbest_asr_tpu.parallel.process_data import \
    ProcessTrainShard as JProcessTrainShard
from nbest_asr_tpu_torch.data.bucketing import (bucket_assignment,
                                                row_lengths)
from nbest_asr_tpu_torch.parallel.process_data import ProcessTrainShard
from nbest_asr_tpu_torch.train.loop import _epoch_step_indices

BUCKETS = [16, 32]


def _split(n_rows, max_len=32, seed=3):
    """Rows of a mix of real lengths, both streams, multi-hot labels."""
    rng = np.random.RandomState(seed)
    lens = rng.choice([6, 10, 14, 20, 28, max_len], size=n_rows)
    ids = np.zeros((n_rows, max_len), np.int32)
    mask = np.zeros((n_rows, max_len), np.float32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(3, 64, n)
        mask[i, :n] = 1.0
    segs = np.zeros_like(ids)
    segs[:, max_len // 2:] = 1
    return {"input_ids": ids, "attn_mask": mask, "segment_ids": segs,
            "trans_input_ids": ids.copy(), "trans_attn_mask": mask.copy(),
            "trans_segment_ids": segs.copy(),
            "labels": (rng.rand(n_rows, 9) < 0.1).astype(np.float32)}


def _micro(blen):
    return 8 if blen <= 16 else 4


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("n_accum", [1, 2])
def test_shard_matches_jax(P, n_accum):
    if P == 3:
        micro = 12 if n_accum == 1 else 6      # divisible by 3
    else:
        micro = None
    data = _split(101)
    micro_for = (lambda blen: micro) if micro else _micro
    for p in range(P):
        j = JProcessTrainShard(data, BUCKETS, process_index=p,
                               process_count=P)
        t = ProcessTrainShard(data, BUCKETS, process_index=p,
                              process_count=P)
        np.testing.assert_array_equal(t.owned_rows, j.owned_rows)
        assert len(t.buckets) == len(j.buckets)
        for tb, jb in zip(t.buckets, j.buckets):
            assert (tb.blen, tb.global_n, tb.local_n) == \
                (jb.blen, jb.global_n, jb.local_n)
            np.testing.assert_array_equal(tb.owned_pos, jb.owned_pos)
            assert tb.data.keys() == jb.data.keys()
            for k in tb.data:
                np.testing.assert_array_equal(tb.data[k], jb.data[k])
        assert t.steps_per_epoch(micro_for, n_accum) == \
            j.steps_per_epoch(micro_for, n_accum)
        rt, rj = np.random.RandomState(42), np.random.RandomState(42)
        for _ in range(2):                       # two epochs
            pt = t.epoch_plan(rt, micro_for, n_accum)
            pj = j.epoch_plan(rj, micro_for, n_accum)
            assert [(b, m) for b, m, _ in pt] == [(b, m) for b, m, _ in pj]
            for (bi, _, it), (_, _, ij) in zip(pt, pj):
                np.testing.assert_array_equal(it, ij)
                for step in range(it.shape[0]):
                    lt, lj = t.local_batch(bi, it[step]), \
                        j.local_batch(bi, ij[step])
                    assert lt.keys() == lj.keys()
                    for k in lt:
                        np.testing.assert_array_equal(lt[k], lj[k])
        assert rt.randint(1 << 30) == rj.randint(1 << 30)


@pytest.mark.parametrize("P", [2, 3, 4])
def test_partition_and_epoch_coverage(P):
    data = _split(101)
    shards = [ProcessTrainShard(data, BUCKETS, process_index=p,
                                process_count=P) for p in range(P)]
    owned = np.concatenate([s.owned_rows for s in shards])
    assert len(owned) == 101 and len(np.unique(owned)) == 101
    plans = [s.epoch_plan(np.random.RandomState(42), lambda b: 12, 1)
             for s in shards]
    for p in plans[1:]:
        assert [(bi, mb, idx.shape) for bi, mb, idx in p] == \
            [(bi, mb, idx.shape) for bi, mb, idx in plans[0]]
    assignment = bucket_assignment(row_lengths(data), BUCKETS, 32)
    seen = []
    for s, plan in zip(shards, plans):
        for bi, _, idx in plan:
            b = s.buckets[bi]
            real = idx[idx < b.local_n]
            assert len(np.unique(real)) == len(real)
            seen.extend(assignment[bi][1][b.owned_pos[real]].tolist())
            lb = s.local_batch(bi, idx[-1])
            assert int(lb["example_mask"].sum()) == \
                int((idx[-1] < b.local_n).sum())
    assert len(seen) == len(set(seen)) and len(seen) >= 90


def test_one_process_plan_is_index_mode():
    data = _split(57, seed=5)
    shard = ProcessTrainShard(data, BUCKETS)
    r_direct, r_index = np.random.RandomState(7), np.random.RandomState(7)
    for bi, mb, idx in shard.epoch_plan(r_direct, lambda b: 8, 2):
        perm = r_index.permutation(shard.buckets[bi].global_n)
        np.testing.assert_array_equal(
            idx, _epoch_step_indices(shard.buckets[bi].global_n, 8, 2,
                                     perm))
    assert r_direct.randint(1 << 30) == r_index.randint(1 << 30)


def test_indivisible_micro_raises_jax_message():
    data = _split(40)
    t = ProcessTrainShard(data, BUCKETS, process_index=0, process_count=3)
    j = JProcessTrainShard(data, BUCKETS, process_index=0, process_count=3)
    with pytest.raises(ValueError) as et:
        t.epoch_plan(np.random.RandomState(0), lambda b: 8, 1)
    with pytest.raises(ValueError) as ej:
        j.epoch_plan(np.random.RandomState(0), lambda b: 8, 1)
    assert str(et.value) == str(ej.value)
