"""The face crop as a bilinear sample: per output value four taps, each a
multiply-add; the interpolation weights per output row and column."""

from __future__ import annotations

CROP = 120


def flops(size: int = CROP, channels: int = 3) -> int:
    return size * size * channels * 4 * 2 + 4 * size * 4
