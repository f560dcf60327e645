"""Median time of the eager ``FusedFrameEngine.regress`` (crop and
regressor) on the cell's first batch and its own rois (CUDA events), in
ms; read from the span ``regress``."""

from perfbench.tracing import percentile


def read(rec):
    s = rec.spans.get("regress")
    return percentile(s, 50) * 1e3 if s else None
