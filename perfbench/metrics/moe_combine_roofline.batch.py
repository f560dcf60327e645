"""Kernel M2's share of its roofline, %: a call's combine
(``perfbench.counts.moe.combine_bytes``: the k T expert outputs and the
residual read once, the output written once, the slots and gates read
once) against the HBM rate, over the trace's time per call in ops whose
name holds ``moe_combine``. The count assumes the design where the combine
is a pass of its own after the expert GEMM; a program without M2 reads
nothing."""

from perfbench.counts import moe
from perfbench.peaks import HBM_BPS
from perfbench.tracing import op_seconds

FRAGMENT = "moe_combine"


def read(rec):
    t = op_seconds(rec.trace, FRAGMENT)
    if t is None:
        return None
    s = moe.call_shape(rec.cfg, rec.traffic)
    nbytes = s["layers"] * moe.combine_bytes(s["tokens"], s["width"],
                                             s["k"], s["dtype"])
    return 100.0 * nbytes / HBM_BPS / t
