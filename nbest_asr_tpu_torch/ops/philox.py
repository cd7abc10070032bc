"""Counter-based Philox4x32-10 dropout masks, the same function in plain
PyTorch (here) and in CUDA (``csrc/philox.cuh``).

The TPU kernels draw their dropout bits from the TPU's hardware PRNG,
reseeded per tile (``nbest_asr_tpu/ops/flash_attention.py:56
_keep_mask``, ``ops/fused_ffn.py:106 _mask_ids``, ``:137 _drop``); those
bits cannot be reproduced off the TPU.  The port keys every mask element
on (seed, stream, absolute row, column) instead:

- key     = (seed mod 2^32, seed >> 32 mod 2^32)
- counter = (column >> 2, row, stream, 0)
- bits    = word ``column & 3`` of Philox4x32-10(counter, key)
- keep    = bits >= min(int(rate * 2^32), 2^32 - 1)  (``_keep_mask``'s rule)

Nothing depends on how a kernel tiles its rows or columns, so a forward
GEMM, a backward GEMM and a row pass that tile the same (n, c) matrix
differently regenerate the same mask, and no mask is ever stored.  The
streams:

- 1: the FFN block's (n, intermediate) mask;
- 2: the FFN block's (n, hidden) mask;
- 3: the attention prob mask -- of the attention block and of both flash
  routes (``ops/flash_attention.py``) -- element (q, k) of head ``head``
  of batch element ``elem`` at row ``(elem * n_heads + head) * s + q`` and
  column ``k``: the (b, n_heads, s, s) probs flattened to rows;
- 4: the attention block's (n, hidden) out-proj mask.

``elem`` and ``s`` are those of the unpadded (b, s) input.  The
attention forwards, the dQ kernels and the dK/dV kernels -- single-block
and tiled, at any tiling -- regenerate the same stream-3 mask.

Philox needs the high 32 bits of a 32 x 32-bit product.  PyTorch has no
uint32 arithmetic, and on int64 that product overflows the sign bit, so
``_mulhilo`` splits the counter word into 16-bit limbs: every partial
product stays below 2^49 and the result is exact.  The known-answer
vectors of Salmon et al. 2011 (Random123) pin it in the tests.

``fold_in`` derives per-site seeds (per micro, per layer, per dropout
site) from one caller seed on the host, as ``jax.random.fold_in`` does
for the JAX package's keys.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57          # Philox4x32 multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments
ROUNDS = 10
MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF

STREAM_INTER = 1      # the FFN's (n, intermediate) dropout
STREAM_HIDDEN = 2     # the FFN's (n, hidden) dropout
STREAM_ATTN_PROB = 3  # the attention probs, (b * n_heads * s, s)
STREAM_ATTN_HIDDEN = 4  # the attention out-proj output, (n, hidden)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m, for an int64 tensor ``a`` of
    values in [0, 2^32) and a 32-bit constant ``m``."""
    p_lo = (a & 0xFFFF) * m                 # < 2^48
    p_hi = (a >> 16) * m                    # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)      # < 2^49
    return (p_hi >> 16) + (t >> 32), t & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of int64 tensors holding uint32 counter words
    (broadcastable) under the key (k0, k1); returns four int64 tensors
    of uint32 words."""
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def threshold(rate: float) -> int:
    """Keep iff bits >= this (``flash_attention._keep_mask``)."""
    return min(int(rate * 2.0 ** 32), 2 ** 32 - 1)


def keep_mask(seed: int, stream: int, row0: int, n_rows: int, n_cols: int,
              rate: float, device="cpu") -> torch.Tensor:
    """(n_rows, n_cols) bool keep-mask of rows row0 .. row0 + n_rows - 1."""
    n_groups = (n_cols + 3) // 4
    rows = torch.arange(row0, row0 + n_rows, dtype=torch.int64,
                        device=device)[:, None]
    groups = torch.arange(n_groups, dtype=torch.int64, device=device)[None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32(groups, rows, zero + stream, zero,
                       seed & MASK32, (seed >> 32) & MASK32)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(n_rows, 4 * n_groups)[:, :n_cols]
    return bits >= threshold(rate)


class Dropout(NamedTuple):
    """One dropout site of a kernel: its Philox seed, rate and stream."""

    seed: int
    rate: float
    stream: int

    @property
    def inv_keep(self) -> float:
        """1 / (1 - rate): the TPU kernels multiply by it in f32."""
        return 1.0 / (1.0 - self.rate)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """The plain dropout of the kernels' epilogues on an (n, c)
        matrix: kept elements times f32(inv_keep), dropped ones 0."""
        keep = keep_mask(self.seed, self.stream, 0, x.shape[0], x.shape[1],
                         self.rate, x.device)
        scale = torch.tensor(self.inv_keep, dtype=x.dtype, device=x.device)
        return torch.where(keep, x * scale, torch.zeros_like(x))


def site(seed: Optional[int], rate: float, stream: int) -> Optional[Dropout]:
    """The ``Dropout`` of a kernel's dropout site, or None at rate 0."""
    if rate <= 0.0:
        return None
    if seed is None:
        raise ValueError("dropout rate > 0 needs a seed")
    return Dropout(int(seed), float(rate), stream)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, *data: int) -> int:
    """A new 63-bit seed from ``seed`` and the integers ``data``."""
    x = seed & MASK64
    for d in data:
        x = _splitmix64(x ^ _splitmix64(d & MASK64))
    return x & (2 ** 63 - 1)


def generator(seed: int, device) -> torch.Generator:
    """A torch.Generator on ``device`` seeded with ``seed``: the plain
    path's dropout bits (``layers.dropout``)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
