"""Device ms of decode (landmarks, kernel B1, pose, rescale to the rois)
inside each call of the captured ``process_batch`` program: the interval
``decode`` between two of the program's stage stamps, median over the
traced window's calls."""

from perfbench.stages import stage_ms


def read(rec):
    return stage_ms(rec, "decode")
