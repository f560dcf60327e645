"""FaceBoxes (arXiv:1708.05234) on an (h, w) canvas: its convolutions, at
the widths of the reference repository's ``models/faceboxes.py``, and its
pools. The CReLU's negation and the folded BatchNorm are elementwise and
not counted; a 7x7/4 convolution counts 49 taps, not the folded s2d8
form's zero taps."""

from __future__ import annotations

from perfbench.counts.conv import conv_flops, out_size, pool_flops

INCEPTION = ((1, 128, 32), (1, 128, 32), (1, 128, 24), (3, 24, 32),
             (1, 128, 24), (3, 24, 32), (3, 32, 32))


def flops(h: int, w: int) -> int:
    total = 0
    h, w = out_size(h, 7, 4, 3), out_size(w, 7, 4, 3)
    total += conv_flops(h, w, 7, 3, 24)
    h, w = out_size(h, 3, 2, 1), out_size(w, 3, 2, 1)
    total += pool_flops(h, w, 3, 48)
    h, w = out_size(h, 5, 2, 2), out_size(w, 5, 2, 2)
    total += conv_flops(h, w, 5, 48, 64)
    h, w = out_size(h, 3, 2, 1), out_size(w, 3, 2, 1)
    total += pool_flops(h, w, 3, 128)
    src1 = (h, w)
    for _ in range(3):
        total += sum(conv_flops(h, w, k, cin, cout)
                     for k, cin, cout in INCEPTION)
        total += pool_flops(h, w, 3, 128)            # the avg-pool branch
    total += conv_flops(h, w, 1, 128, 128)
    h, w = out_size(h, 3, 2, 1), out_size(w, 3, 2, 1)
    total += conv_flops(h, w, 3, 128, 256)
    src2 = (h, w)
    total += conv_flops(h, w, 1, 256, 128)
    h, w = out_size(h, 3, 2, 1), out_size(w, 3, 2, 1)
    total += conv_flops(h, w, 3, 128, 256)
    src3 = (h, w)
    for (sh, sw), cin, a in ((src1, 128, 21), (src2, 256, 1),
                             (src3, 256, 1)):
        total += conv_flops(sh, sw, 3, cin, a * 6)   # loc (4a) + conf (2a)
    return total
