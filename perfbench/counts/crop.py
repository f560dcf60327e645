"""The face crop as a bilinear sample at s x s pixels (the configuration's
``regressor.crop``): per output value four taps, each a multiply-add; the
interpolation weights per output row and column; the crop's float32
values written once and its roi's four floats read once."""

from __future__ import annotations


def flops(size: int, channels: int = 3) -> int:
    return size * size * channels * 4 * 2 + 4 * size * 4


def nbytes(size: int, channels: int = 3) -> int:
    return size * size * channels * 4 + 4 * 4
