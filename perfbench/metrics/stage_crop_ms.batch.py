"""Device ms of the crop (`crop_resize_matmul`) inside each call of the
captured ``process_batch`` program: the interval ``crop`` between two of
the program's stage stamps, median over the traced window's calls."""

from perfbench.stages import stage_ms


def read(rec):
    return stage_ms(rec, "crop")
