"""Device ms of the regressor's backbone on the crops, without the crop
inside each call of the captured ``process_batch`` program: the interval
``regress`` between two of the program's stage stamps, median over the
traced window's calls."""

from perfbench.stages import stage_ms


def read(rec):
    return stage_ms(rec, "regress")
