"""Kernel R1's share of its roofline, %: every face's split-attention
blocks (``perfbench.counts.split_attention`` at the configuration's crop,
layers, radix, cardinality, width and dtype: each radix tensor read once
and each combined tensor written once) against the HBM rate, over the
trace's time per call in ops whose name holds ``splat_`` (R1's
``splat_pool_kernel`` and ``splat_combine_kernel``). The faces are the
call's face slots, all of which the regressor runs. The bytes are what
any implementation must move, so the share reads the same work whatever
computes it and cannot pass 100%; a program without R1 reads nothing."""

from perfbench.counts import split_attention
from perfbench.peaks import HBM_BPS
from perfbench.tracing import op_seconds

FRAGMENT = "splat_"


def read(rec):
    t = op_seconds(rec.trace, FRAGMENT)
    if t is None:
        return None
    faces = rec.traffic["frames_per_call"] * rec.cfg["max_faces"]
    nbytes = faces * split_attention.nbytes(rec.cfg["regressor"],
                                            rec.cfg["dtype"])
    return 100.0 * nbytes / HBM_BPS / t
