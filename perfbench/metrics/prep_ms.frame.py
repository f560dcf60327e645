"""Median time of ``prepare_frame`` on the cell's frames, host clock
ended by a synchronize, in ms; read from the span ``prep``."""

from perfbench.tracing import percentile


def read(rec):
    s = rec.spans.get("prep")
    return percentile(s, 50) * 1e3 if s else None
