"""Device ms per call of the mixture-of-experts layers' kernels: the
trace's ops whose names hold ``moe_`` (the route and dispatch M1, the
grouped expert GEMM G1 and the combine M2: ``moe_dispatch_*``,
``moe_gemm_kernel``, ``moe_combine_kernel``), summed, per traced call. A
program without them reads nothing."""

from perfbench.tracing import op_seconds

FRAGMENT = "moe_"


def read(rec):
    t = op_seconds(rec.trace, FRAGMENT)
    return None if t is None else 1e3 * t
