"""MobileNetV2 1.0 (arXiv:1801.04381) with the 12/40/10 head, at s x s
input: convolutions and the head's dense layers."""

from __future__ import annotations

from perfbench.counts.conv import conv_flops, out_size

SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def flops(s: int) -> int:
    h = out_size(s, 3, 2, 1)
    total = conv_flops(h, h, 3, 3, 32)
    cin = 32
    for t, c, n, st in SETTING:
        for i in range(n):
            hid = cin * t
            if t != 1:
                total += conv_flops(h, h, 1, cin, hid)
            h = out_size(h, 3, st if i == 0 else 1, 1)
            total += conv_flops(h, h, 3, hid, hid, groups=hid)
            total += conv_flops(h, h, 1, hid, c)
            cin = c
    total += conv_flops(h, h, 1, cin, 1280)
    return total + 2 * 1280 * 62
