"""ResNeSt-50 (arXiv:2004.08955: layers 3-4-6-3, radix 2, cardinality 1,
bottleneck width 64, deep stem of width 32, avg_down, avd) with the
12/40/10 head, at s x s input: convolutions and dense layers; the split
attention's softmax and the pools are elementwise and not counted."""

from __future__ import annotations

from perfbench.counts.conv import conv_flops, out_size

LAYERS = (3, 4, 6, 3)
RADIX = 2
STEM = 32


def flops(s: int) -> int:
    h = out_size(s, 3, 2, 1)
    total = (conv_flops(h, h, 3, 3, STEM) + conv_flops(h, h, 3, STEM, STEM)
             + conv_flops(h, h, 3, STEM, 2 * STEM))
    h = out_size(h, 3, 2, 1)
    cin = 2 * STEM
    for stage, n in enumerate(LAYERS):
        planes = 64 * 2 ** stage
        inter = max(planes * RADIX // 4, 32)
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            total += conv_flops(h, h, 1, cin, planes)
            total += conv_flops(h, h, 3, planes, planes * RADIX,
                                groups=RADIX)
            total += 2 * (planes * inter + inter * planes * RADIX)
            hin = h
            h = out_size(h, 3, stride, 1)
            total += conv_flops(h, h, 1, planes, 4 * planes)
            if stride != 1 or cin != 4 * planes:
                hs = out_size(hin, stride, stride, 0, ceil=True)
                total += conv_flops(hs, hs, 1, cin, 4 * planes)
            cin = 4 * planes
    return total + 2 * cin * 62
