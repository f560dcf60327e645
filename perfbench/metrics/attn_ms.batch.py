"""Device ms per call of the attention kernels the program launches: the
trace's ops whose names hold ``flash_fwd`` (FlashAttention's forward
kernels, the split-KV kernel and its combine included), summed, per
traced call."""

from perfbench.tracing import op_seconds

FRAGMENT = "flash_fwd"


def read(rec):
    t = op_seconds(rec.trace, FRAGMENT)
    return None if t is None else 1e3 * t
