"""Seconds the program spent building its captured programs: its set-up
spans ``synergy.warmup`` (eager warm-up calls) and ``synergy.capture``
(the capture), summed over the run's programs. The kernels' builds fall
outside both: the program makes them when its engine is built."""

from perfbench.stages import setup_seconds


def read(rec):
    return setup_seconds(rec)
