"""MobileNetV1 1.0 (arXiv:1704.04861) with the 12/40/10 head, at s x s
input: convolutions and the head's dense layers."""

from __future__ import annotations

from perfbench.counts.conv import conv_flops, out_size

PAIRS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
         (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
         (1024, 1))


def flops(s: int) -> int:
    h = out_size(s, 3, 2, 1)
    total = conv_flops(h, h, 3, 3, 32)
    cin = 32
    for c, st in PAIRS:
        h = out_size(h, 3, st, 1)
        total += conv_flops(h, h, 3, cin, cin, groups=cin)
        total += conv_flops(h, h, 1, cin, c)
        cin = c
    return total + 2 * cin * 62
