"""Kernel G1's share of its roofline, %: the routed expert products of a
call (``perfbench.counts.moe.gemm_flops``, 4 rows D H over each MoE
layer, rows the k T token-expert pairs of a dropless layer, T the call's
face slots times the tokens of the configuration's crop) against the bf16
peak, over the trace's time per call in ops whose name holds
``moe_gemm``. The count assumes the design where every (token, expert)
row is computed once and no padding row is counted, so a kernel that
computes padding rows reads lower, and the share cannot pass 100%; a
program without G1 reads nothing."""

from perfbench.counts import moe
from perfbench.peaks import BF16_FLOPS
from perfbench.tracing import op_seconds

FRAGMENT = "moe_gemm"


def read(rec):
    t = op_seconds(rec.trace, FRAGMENT)
    if t is None:
        return None
    s = moe.call_shape(rec.cfg, rec.traffic)
    flops = s["layers"] * moe.gemm_flops(s["tokens"], s["width"], s["mlp"],
                                         s["k"])
    return 100.0 * flops / BF16_FLOPS / t
