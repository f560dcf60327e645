"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W), and the roofline bound of a piece of work against them.
A share of a peak is stated with the card's power limit beside it."""

from __future__ import annotations

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12           # outside the tensor cores


def bound(nbytes: float, flops: float, peak: float):
    """(seconds, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
