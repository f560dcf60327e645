"""Faces returned per second: ``n_faces`` summed over every call completed
in the window, over the window's seconds (device synchronised at its
close)."""

from perfbench.tracing import rate


def read(rec):
    return rate(rec.window["units"], rec.window["seconds"])
