"""Kernel F1's share of its roofline, %: every face's exchange outputs
(``perfbench.counts.hr_fuse`` at the configuration's crop, widths, modules
and dtype: each term read once at its own resolution, the identity read
once, the output written once) against the HBM rate, over the trace's time
per call in ops whose name holds ``hrfuse_`` (F1's ``hrfuse_kernel``). The
faces are the call's face slots, all of which the regressor runs. The
bytes are what any implementation must move, so the share reads the same
work whatever computes it and cannot pass 100%; a program without F1 reads
nothing."""

from perfbench.counts import hr_fuse
from perfbench.peaks import HBM_BPS
from perfbench.tracing import op_seconds

FRAGMENT = "hrfuse_"


def read(rec):
    t = op_seconds(rec.trace, FRAGMENT)
    if t is None:
        return None
    faces = rec.traffic["frames_per_call"] * rec.cfg["max_faces"]
    nbytes = faces * hr_fuse.nbytes(rec.cfg["regressor"], rec.cfg["dtype"])
    return 100.0 * nbytes / HBM_BPS / t
