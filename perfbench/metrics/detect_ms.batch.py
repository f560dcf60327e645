"""Median time of the eager ``FusedFrameEngine.detect_candidates`` on the
cell's first batch (CUDA events), in ms; read from the span ``detect``."""

from perfbench.tracing import percentile


def read(rec):
    s = rec.spans.get("detect")
    return percentile(s, 50) * 1e3 if s else None
