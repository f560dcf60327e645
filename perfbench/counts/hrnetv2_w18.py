"""HRNetV2-W18 (arXiv:1908.07919, the facial-landmark form: branches of
18, 36, 72 and 144 channels, stages of 1, 4 and 3 modules, 4 BasicBlocks a
branch, a stem of two 3x3 stride-2 convs of width 64, four Bottlenecks of
64 -> 256) with the 12/40/10 head on the 270-channel HRNetV2 head, at s x
s input, s a multiple of 32: convolutions and dense layers; the
BatchNorms, ReLUs, sums, upsamples and the pool are elementwise and not
counted."""

from __future__ import annotations

from perfbench.counts.conv import conv_flops, out_size

WIDTHS = (18, 36, 72, 144)
MODULES = (1, 4, 3)
BLOCKS = 4
STEM = 64


def exchange_flops(sizes, widths) -> int:
    """One exchange unit's convolutions over branches at ``sizes``: for
    j > i a 1x1 conv at branch j's extent, for j < i (i - j) 3x3
    stride-2 convs, the last to branch i's width."""
    n = len(sizes)
    total = 0
    for i in range(n):
        for j in range(n):
            if j > i:
                total += conv_flops(sizes[j], sizes[j], 1, widths[j],
                                    widths[i])
            for k in range(i - j):
                cout = widths[j] if k < i - j - 1 else widths[i]
                h = sizes[j + k + 1]
                total += conv_flops(h, h, 3, widths[j], cout)
    return total


def flops(s: int, modules=MODULES) -> int:
    """At s x s input; ``modules`` of stages 2, 3 and 4 (fewer for
    tests)."""
    widths, blocks = WIDTHS, BLOCKS
    h = out_size(s, 3, 2, 1)
    total = conv_flops(h, h, 3, 3, STEM)
    h = out_size(h, 3, 2, 1)
    total += conv_flops(h, h, 3, STEM, STEM)
    cin = STEM
    for _ in range(4):
        total += (conv_flops(h, h, 1, cin, 64) + conv_flops(h, h, 3, 64, 64)
                  + conv_flops(h, h, 1, 64, 256))
        if cin != 256:
            total += conv_flops(h, h, 1, cin, 256)
        cin = 256
    sizes = [h, out_size(h, 3, 2, 1)]
    total += (conv_flops(h, h, 3, 256, widths[0])
              + conv_flops(sizes[1], sizes[1], 3, 256, widths[1]))
    for stage, n in enumerate(modules):
        branches = stage + 2
        if branches > len(sizes):
            new = out_size(sizes[-1], 3, 2, 1)
            total += conv_flops(new, new, 3, widths[branches - 2],
                                widths[branches - 1])
            sizes.append(new)
        per_module = sum(2 * blocks * conv_flops(hb, hb, 3, c, c)
                         for hb, c in zip(sizes, widths))
        total += n * (per_module + exchange_flops(sizes, widths))
    head = sum(widths)
    total += conv_flops(h, h, 1, head, head)
    return total + 2 * head * 62
