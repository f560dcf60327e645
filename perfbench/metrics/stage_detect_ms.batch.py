"""Device ms of detect (FaceBoxes on the s2d frames, anchor decode) inside
each call of the captured ``process_batch`` program: the interval
``detect`` between two of the program's stage stamps, median over the
traced window's calls."""

from perfbench.stages import stage_ms


def read(rec):
    return stage_ms(rec, "detect")
