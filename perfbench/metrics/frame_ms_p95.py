"""The 95th percentile of the same frames' times as ``frame_ms_p50``, ms."""

from perfbench.tracing import percentile


def read(rec):
    return percentile(rec.window["latencies_s"], 95) * 1e3
