"""Greedy NMS as kernel N1's contract needs it for given candidates:
the IoUs that the reference's loop (``cpu_nms.pyx``) evaluates, each kept
box against the valid boxes after it, 15 float32 operations each; the
walk's dependent steps (the last valid box + 1 of the longest frame), one
SM cycle each; the boxes and flags read once, the flags written once."""

from __future__ import annotations


def work(torch, valid, keep):
    """(B, K) valid and kept flags -> (bytes, IoUs, walk steps)."""
    b, k = valid.shape
    steps = int((torch.arange(1, k + 1, device=valid.device)
                 * valid).amax())
    after = valid.flip(-1).long().cumsum(-1).flip(-1) - valid.long()
    ious = int((after * keep).sum())
    return b * k * (16 + 1 + 1), ious, steps


def bound_s(nbytes, ious, steps, clock_mhz, f32_flops, hbm_bps):
    return max(ious * 15 / f32_flops, steps / (clock_mhz * 1e6),
               nbytes / hbm_bps)
