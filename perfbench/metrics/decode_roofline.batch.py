"""Kernel B1's share of its roofline, %: the dense decode of the call's
faces (``perfbench.counts.decode``, float32 operations) over the trace's
``decode_kernel`` time per call."""

from perfbench.counts import decode
from perfbench.peaks import F32_FLOPS, bound
from perfbench.tracing import op_seconds


def read(rec):
    t = op_seconds(rec.trace, "decode_kernel")
    if t is None:
        return None
    faces = rec.traffic["frames_per_call"] * rec.cfg["max_faces"]
    return 100.0 * bound(*decode.work(faces), F32_FLOPS)[0] / t
