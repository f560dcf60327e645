#!/usr/bin/env python3
"""The benchmark of the PyTorch + CUDA port, one run of one cell:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding one CUDA card per chip the cell asks
for. Set-up (weights from the seed, the program built, every shape of the
cell warmed), a window of ``--seconds``, with ``--trace 1`` a traced
window and the stage spans, then the check against the plain reference;
prints the check's numbers on standard error and one JSON line last on
standard output. Exits non-zero, printing no result, without enough
cards.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path[0] = ROOT           # the checkout, not this folder
    from perfbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))
