"""The model's operations per call (``perfbench.counts.call_flops``: the
detector on every canvas, the crop as bilinear taps, the regressor at the
configuration's crop size and the landmark and dense decode of every face)
over the wall time per call of the measured window, as a share of the
card's bf16 peak, in %."""

from perfbench.counts import call_flops
from perfbench.peaks import BF16_FLOPS


def read(rec):
    w = rec.window
    if not w["calls"]:
        return None
    frames = rec.traffic.get("frames_per_call", 1)
    faces = w["units"] / w["calls"] if rec.traffic["entry"] == \
        "process_batch" else rec.cfg["max_faces"]
    per_call = w["seconds"] / w["calls"]
    return 100.0 * call_flops(rec.cfg, frames, faces) / per_call / BF16_FLOPS
