"""The detector stem as FaceBoxes defines it, whatever kernel runs it:
the 7x7/4 CReLU convolution 3 -> 24 and the 3x3/2 max-pool after it, on
(b, h, w, 3) frames. Bytes: the frame read once and the pooled 48-channel
output written once, in the served dtype (``elem`` bytes)."""

from __future__ import annotations

from perfbench.counts.conv import conv_flops, out_size, pool_flops


def work(b: int, h: int, w: int, elem: int = 2):
    """(bytes, operations)."""
    ch, cw = out_size(h, 7, 4, 3), out_size(w, 7, 4, 3)
    ph, pw = out_size(ch, 3, 2, 1), out_size(cw, 3, 2, 1)
    ops = b * (conv_flops(ch, cw, 7, 3, 24) + pool_flops(ph, pw, 3, 48))
    return b * elem * (h * w * 3 + ph * pw * 48), ops
