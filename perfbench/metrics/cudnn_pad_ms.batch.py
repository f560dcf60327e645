"""Device ms per call in cuDNN's NHWC channel copies: the trace's ops whose
names hold ``nhwcAddPaddingKernel`` (an activation copied into a buffer
padded to the channel multiple its tensor-core convolutions take) or
``nhwcSliceCKernel`` (a result sliced back to its channels), summed, per
traced call. A trace without them reads 0; no trace reads nothing."""

FRAGMENTS = ("nhwcAddPaddingKernel", "nhwcSliceCKernel")


def read(rec):
    if not rec.trace:
        return None
    s = sum(v for k, v in rec.trace["per_op_s"].items()
            if any(f in k for f in FRAGMENTS))
    return 1e3 * s / rec.trace["calls"]
