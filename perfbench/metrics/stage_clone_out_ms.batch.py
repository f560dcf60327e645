"""Device ms of the clone of the program's outputs inside each call of the
captured ``process_batch`` program: the interval ``clone_out`` between
two of the program's stage stamps, median over the traced window's
calls."""

from perfbench.stages import stage_ms


def read(rec):
    return stage_ms(rec, "clone_out")
