"""Kernel C1's share of its roofline, %: the crops of the call's faces
written once and their rois read once (S x S x 3 float32 values, S the
configuration's ``regressor.crop``, and four floats a face) and the
bilinear operations of ``perfbench.counts.crop``, against the HBM rate and
the float32 peak, over the trace's ``crop_bilinear_kernel`` time per call.
The source pixels the taps read are left out of the bytes, so the share is
a lower bound of the traffic's and cannot pass 100%."""

from perfbench.counts import crop
from perfbench.peaks import F32_FLOPS, bound
from perfbench.tracing import op_seconds


def read(rec):
    t = op_seconds(rec.trace, "crop_bilinear_kernel")
    if t is None:
        return None
    size = rec.cfg["regressor"]["crop"]
    faces = rec.traffic["frames_per_call"] * rec.cfg["max_faces"]
    return 100.0 * bound(faces * crop.nbytes(size), faces * crop.flops(size),
                         F32_FLOPS)[0] / t
