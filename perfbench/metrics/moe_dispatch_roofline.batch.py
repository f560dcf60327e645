"""Kernel M1's share of its roofline, %: a call's route and dispatch
(``perfbench.counts.moe``: the tokens read once, the router's weight read
once, the dispatched rows written once, the slots and gates written once;
the router's operations beside them) against the HBM rate or the f32 peak,
whichever bounds, over the trace's time per call in ops whose name holds
``moe_dispatch``. The count assumes the design where the dispatch copies
each token's row into an expert-contiguous buffer: a design that gathers
the rows inside the expert GEMM instead moves other bytes and needs
another count. A program without M1 reads nothing."""

from perfbench.counts import moe
from perfbench.peaks import F32_FLOPS, bound
from perfbench.tracing import op_seconds

FRAGMENT = "moe_dispatch"


def read(rec):
    t = op_seconds(rec.trace, FRAGMENT)
    if t is None:
        return None
    s = moe.call_shape(rec.cfg, rec.traffic)
    nbytes = s["layers"] * moe.dispatch_bytes(s["tokens"], s["width"],
                                              s["experts"], s["k"],
                                              s["dtype"])
    flops = s["layers"] * moe.router_flops(s["tokens"], s["width"],
                                           s["experts"])
    return 100.0 * bound(nbytes, flops, F32_FLOPS)[0] / t
