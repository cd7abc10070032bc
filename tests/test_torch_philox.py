"""The port's Philox4x32-10 (``ops/philox.py``), the plain version of the
CUDA kernels' dropout bits: the Random123 known-answer vectors (Salmon et
al. 2011), masks independent of how rows and columns are split, the keep
rate, and the seed folding."""

import numpy as np
import pytest
import torch

from nbest_asr_tpu_torch.ops.philox import (Dropout, fold_in, keep_mask,
                                            philox4x32, site, threshold)

# (counter, key) -> output, Random123's kat_vectors for philox4x32 10
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_known_answer_vectors(ctr, key, want):
    words = philox4x32(*(torch.tensor(c, dtype=torch.int64) for c in ctr),
                       *key)
    assert tuple(int(w) for w in words) == want


def test_vectorised_matches_scalar():
    """A batch of counters gives each counter's own scalar answer."""
    c0 = torch.tensor([0, 7, 0xFFFFFFFF, 123456789], dtype=torch.int64)
    batch = philox4x32(c0, c0 * 0 + 5, c0 * 0 + 1, c0 * 0, 11, 22)
    for i, c in enumerate(c0.tolist()):
        one = philox4x32(*(torch.tensor(v, dtype=torch.int64)
                           for v in (c, 5, 1, 0)), 11, 22)
        assert [int(w[i]) for w in batch] == [int(w) for w in one]


@pytest.mark.parametrize("split", [1, 20, 47])
def test_mask_independent_of_row_split(split):
    whole = keep_mask(99, 1, 0, 48, 256, 0.25)
    parts = torch.cat([keep_mask(99, 1, 0, split, 256, 0.25),
                       keep_mask(99, 1, split, 48 - split, 256, 0.25)])
    assert torch.equal(whole, parts)


def test_mask_independent_of_column_extent_and_keyed():
    wide = keep_mask(7, 2, 5, 30, 768, 0.1)
    assert torch.equal(keep_mask(7, 2, 5, 30, 10, 0.1), wide[:, :10])
    assert not torch.equal(keep_mask(7, 1, 5, 30, 768, 0.1), wide)
    assert not torch.equal(keep_mask(8, 2, 5, 30, 768, 0.1), wide)
    # the high seed word is part of the key
    assert not torch.equal(keep_mask(7 + 2 ** 32, 2, 5, 30, 768, 0.1), wide)


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5])
def test_keep_rate(rate):
    m = keep_mask(3, 1, 0, 64, 3072, rate)
    n = m.numel()
    assert abs(m.float().mean().item() - (1 - rate)) <= \
        4 * np.sqrt(rate * (1 - rate) / n)


def test_threshold_and_apply():
    assert threshold(0.0) == 0 and threshold(1.0) == 2 ** 32 - 1
    assert threshold(0.25) == 2 ** 30
    assert site(5, 0.0, 1) is None
    with pytest.raises(ValueError, match="seed"):
        site(None, 0.1, 1)
    d = Dropout(5, 0.1, 1)
    x = torch.randn(16, 40)
    keep = keep_mask(5, 1, 0, 16, 40, 0.1)
    inv = torch.tensor(1.0 / 0.9, dtype=torch.float32)
    assert torch.equal(d.apply(x), torch.where(keep, x * inv,
                                               torch.zeros_like(x)))


def test_fold_in():
    assert fold_in(1, 2, 3) == fold_in(1, 2, 3)
    seeds = {fold_in(s, layer, site_) for s in range(3)
             for layer in range(12) for site_ in range(4)}
    assert len(seeds) == 3 * 12 * 4
    assert all(0 <= s < 2 ** 63 for s in seeds)
