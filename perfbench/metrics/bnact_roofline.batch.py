"""Kernel BN1's share of its roofline, %: every face's BatchNorm +
activation + residual sites (``perfbench.counts.bn_act`` at the
configuration's architecture, crop, widths and dtype: each conv output and
shortcut read once, each result written once) against the HBM rate, over
the trace's time per call in ops whose name holds ``bnact_`` (BN1's
``bnact_kernel``). The faces are the call's face slots, all of which the
regressor runs. The bytes are what any implementation must move, so the
share reads the same work whatever computes it and cannot pass 100%; a
program without BN1 reads nothing."""

from perfbench.counts import bn_act
from perfbench.peaks import HBM_BPS
from perfbench.tracing import op_seconds

FRAGMENT = "bnact_"


def read(rec):
    t = op_seconds(rec.trace, FRAGMENT)
    if t is None:
        return None
    per_face = bn_act.nbytes(rec.cfg["regressor"], rec.cfg["dtype"])
    if per_face is None:
        return None
    faces = rec.traffic["frames_per_call"] * rec.cfg["max_faces"]
    return 100.0 * faces * per_face / HBM_BPS / t
