"""Device ms, inside each call of the captured ``process_batch`` program,
of the copy of the call's frames into the program's static inputs and the
graph's launch: the interval ``copy_in`` between the stamp before the
copy and the first stamp of the graph, median over the traced window's
calls."""

from perfbench.stages import stage_ms


def read(rec):
    return stage_ms(rec, "copy_in")
