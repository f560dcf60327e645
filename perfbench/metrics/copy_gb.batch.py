"""GB a call copies into the captured program's static inputs and clones
out of its outputs (the program's byte counters over its calls)."""

from perfbench.stages import copy_gb


def read(rec):
    return copy_gb(rec)
