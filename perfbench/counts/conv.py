"""Operations of convolutions and pools: 2 per multiply-add of a
convolution, one comparison or addition per window element of a pool."""

from __future__ import annotations


def out_size(n: int, k: int, s: int, p: int, ceil: bool = False) -> int:
    num = n + 2 * p - k
    return (-(-num // s) if ceil else num // s) + 1


def conv_flops(h: int, w: int, k: int, cin: int, cout: int, groups: int = 1
               ) -> int:
    """A convolution's operations at output size (h, w)."""
    return 2 * h * w * k * k * (cin // groups) * cout


def pool_flops(h: int, w: int, k: int, c: int) -> int:
    return h * w * k * k * c
