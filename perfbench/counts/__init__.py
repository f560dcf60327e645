"""Work counts: the operations and bytes of each operation of the served
path at a cell's shapes, from the shapes alone, one file per operation.

A count is the work as the model or the kernel's contract defines it:
each input byte read once, each output byte written once, whatever an
implementation computes besides (zero taps of a folded convolution, a
dense interpolation product). :func:`call_flops` sums a configuration's
model operations for a call.
"""

from __future__ import annotations


def call_flops(cfg: dict, frames: int, faces: int) -> float:
    """The model's operations for ``frames`` canvases and ``faces``
    faces: the detector on every canvas, then per face the bilinear crop
    and the regressor at the configuration's crop size (``regressor.crop``,
    the regressor's ``counts/<arch>.py``) and the landmark and dense
    decode."""
    from perfbench import by_name
    from perfbench.counts import crop, decode, faceboxes
    h, w = cfg["canvas"]
    size = cfg["regressor"]["crop"]
    reg = by_name(__name__, cfg["regressor"]["arch"])
    return (frames * faceboxes.flops(h, w)
            + faces * (reg.flops(size) + crop.flops(size)
                       + decode.flops(1, decode.NVER)
                       + decode.flops(1, decode.N_LMK)))
