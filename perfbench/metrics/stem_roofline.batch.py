"""Kernel B4's share of its roofline, %: the least time of the stem as
FaceBoxes defines it (``perfbench.counts.stem``: the 7x7/4 CReLU conv
3 -> 24 and its 3x3/2 max-pool, bf16 frames in and pooled maps out) over
the trace's ``stem_kernel`` time per call."""

from perfbench.counts import stem
from perfbench.peaks import BF16_FLOPS, bound
from perfbench.tracing import op_seconds


def read(rec):
    t = op_seconds(rec.trace, "stem_kernel")
    if t is None:
        return None
    h, w = rec.traffic["frame_hw"]
    nbytes, ops = stem.work(rec.traffic["frames_per_call"], h, w)
    return 100.0 * bound(nbytes, ops, BF16_FLOPS)[0] / t
