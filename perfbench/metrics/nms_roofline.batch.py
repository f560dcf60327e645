"""Kernel N1's share of its roofline, %: the IoUs and walk steps that the
call's own candidates need (``perfbench.counts.nms`` on the program's
top-2,048 candidates of each ring batch, kept by the reference's greedy
NMS) over the trace's ``nms_tile_`` time per call."""

from perfbench.counts import nms
from perfbench.peaks import F32_FLOPS, HBM_BPS
from perfbench.tracing import op_seconds


def read(rec):
    t = op_seconds(rec.trace, "nms_tile_")
    work = rec.inputs.get("nms")
    clock = rec.card.get("sm_clock_mhz")
    if t is None or not work or not clock:
        return None
    b = sum(nms.bound_s(*w, clock, F32_FLOPS, HBM_BPS) for w in work)
    return 100.0 * b / len(work) / t
