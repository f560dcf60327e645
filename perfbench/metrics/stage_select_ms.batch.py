"""Device ms of select (top-k sort, kernel N1, the keep partition, square
rois) inside each call of the captured ``process_batch`` program: the
interval ``select`` between two of the program's stage stamps, median
over the traced window's calls."""

from perfbench.stages import stage_ms


def read(rec):
    return stage_ms(rec, "select")
