"""Median, over every frame of the window, of the host-clock time from the
numpy frame handed to the entry to its numpy outputs returned, in ms."""

from perfbench.tracing import percentile


def read(rec):
    return percentile(rec.window["latencies_s"], 50) * 1e3
