"""Device ms per call of kernel F1, HRNet's exchange units: the trace's ops
whose names hold ``hrfuse_`` (F1's ``hrfuse_kernel``), summed, per traced
call; a program without F1 reads nothing."""

from perfbench.tracing import op_seconds

FRAGMENT = "hrfuse_"


def read(rec):
    t = op_seconds(rec.trace, FRAGMENT)
    return None if t is None else 1e3 * t
