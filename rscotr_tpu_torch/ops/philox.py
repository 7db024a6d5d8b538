"""Counter-based random bits for the dropout inside K2 / K2b (plain PyTorch).

Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC'11), with the round constants curand and Random123 use: a 128-bit
counter and a 64-bit key give four 32-bit words, a pure function of the
two. ``csrc/philox.cuh`` computes the same function on the card.

The window-attention dropout (``ops/window_attention.py``) reads word 0 of
the counter that is an element's flat index in the (B, nW, H, n, n)
probabilities, under the key ``seed`` (one 63-bit draw per call from the
caller's generator, ``draw_seed``), and keeps the element when that word,
as a fraction of 2^32, is at least the rate: ``word >= keep_threshold(p)``.
Nothing of that size is drawn or stored: the backward and a ``with_cp``
recompute regenerate the same bits from the seed.

The words are computed here with int64 tensor ops. A 32 x 32-bit product
does not fit in int64, so ``_mulhilo`` multiplies by the 16-bit halves of
the constant and carries exactly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

MASK32 = 0xFFFFFFFF
# multipliers and key increments (curand_philox4x32_x.h, Random123)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
ROUNDS = 10
# the seed range: [0, 2^63), an int64 on the operators' schemas
SEED_HIGH = 2 ** 63 - 1


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product ``a * m``, for int64
    ``a`` holding values below 2^32 and a 32-bit constant ``m``; every
    intermediate stays below 2^49."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    low = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (low >> 32), low & MASK32


def philox4x32(counter, key: int):
    """Philox4x32-10 of ``counter`` (four int64 tensors or ints, each a
    32-bit word) under the 64-bit ``key``: the four output words as int64
    tensors."""
    c = [torch.as_tensor(x, dtype=torch.int64) for x in counter]
    k0, k1 = key & MASK32, (key >> 32) & MASK32
    for r in range(ROUNDS):
        hi0, lo0 = _mulhilo(c[0], PHILOX_M[0])
        hi1, lo1 = _mulhilo(c[2], PHILOX_M[1])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
    return c


def keep_threshold(p: float) -> int:
    """The least 32-bit word that keeps an element at dropout rate ``p``:
    ceil(p * 2^32) (exact: the product is a power-of-two scaling), 2^32 at
    p = 1, where nothing is kept."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout rate {p} outside [0, 1]")
    return math.ceil(p * 2.0 ** 32)


def keep_scale(p: float) -> float:
    """What a kept element is multiplied by: 1 / (1 - p) (0 at p = 1, where
    nothing is kept)."""
    return 0.0 if p >= 1.0 else 1.0 / (1.0 - p)


def keep_mask(shape, p: float, seed: int,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """Bool keep mask of ``shape``: element ``i`` (its flat index) is kept
    when word 0 of Philox4x32-10(counter (i, i >> 32, 0, 0), key ``seed``)
    is at least ``keep_threshold(p)``."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    word = philox4x32((idx & MASK32, idx >> 32, 0, 0), int(seed))[0]
    return (word >= keep_threshold(p)).reshape(shape)


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """One 63-bit key from ``generator`` (on its device): the seed of one
    dropout call."""
    if generator is None:
        raise ValueError("a training-mode attention dropout needs a "
                         "torch.Generator")
    return int(torch.randint(0, SEED_HIGH, (), generator=generator,
                             device=generator.device))
