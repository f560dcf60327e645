"""Counter-based keyed draws: the same bits on the CPU and on the card.

A draw is a pure function of integers: a 32-bit ``key`` (made on the host
from a seed and any further words with :func:`make_key`), a per-row index
and the element's position in the row. So a row's draws depend only on
``(key, index)``, whatever rows share its batch and whatever device
computes them, and a whole batch is drawn by a handful of elementwise
int64 tensor ops, with no generator per row and no host round trip.

The mixer is the 32-bit integer hash ``x ^= x >> 16; x *= 0x45d9f3b``
applied twice, then ``x ^= x >> 16``. Every value is masked to 32 bits
before a product, and both multipliers are below 2^31, so no
intermediate reaches 2^63: signed int64 overflow never happens.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B          # the hash's multiplier, < 2^27
_STEP = 0x7FEB352D        # odd element stride, < 2^31


def _mix_int(x: int) -> int:
    x &= _M32
    x = (((x >> 16) ^ x) * _MIX) & _M32
    x = (((x >> 16) ^ x) * _MIX) & _M32
    return (x >> 16) ^ x


def _mix(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix_int` on an int64 tensor of values in [0, 2^32)."""
    x = (((x >> 16) ^ x) * _MIX) & _M32
    x = (((x >> 16) ^ x) * _MIX) & _M32
    return (x >> 16) ^ x


def make_key(*words: int) -> int:
    """A 32-bit key from non-negative integer words (a seed, an epoch, a
    stream number ...): each word is folded in by one mix."""
    key = 0
    for w in words:
        if w < 0:
            raise ValueError(f"key words must be >= 0, got {w}")
        key = _mix_int(key ^ _mix_int(w & _M32) ^ (w >> 32))
    return key


def bits(key: int, index: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) int64 row indices -> (B, n) int64 draws in [0, 2^32)."""
    index = index.to(torch.int64)
    row = _mix((_mix(index & _M32) ^ (key & _M32)) & _M32)       # (B,)
    e = torch.arange(n, dtype=torch.int64, device=index.device) * _STEP
    return _mix((row[:, None] + e[None, :]) & _M32)


def uniform(key: int, index: torch.Tensor, n: int, low: float, high: float
            ) -> torch.Tensor:
    """(B, n) float32 in [low, high): 24 random bits per value."""
    u = (bits(key, index, n) >> 8).to(torch.float32) * (2.0 ** -24)
    return u * (high - low) + low


def randint(key: int, index: torch.Tensor, n: int, low: int, high: int
            ) -> torch.Tensor:
    """(B, n) int64 in [low, high)."""
    return bits(key, index, n) % (high - low) + low
