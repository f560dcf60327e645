"""On the card: one short run of every cell through the benchmark's
command line, correct, with its result line last. Run on a machine with
a card: ``python -m pytest perfbench/tests/test_perfbench_gpu.py``."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "2147483700", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert line["correct"], line["check"]
    assert line["device"]["platform"] == "gpu"


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "sys.argv = ['run.py', '--workload', %r, '--seed', '1', "
            "'--seconds', '1', '--trace', '0']; sys.path[0] = %r; "
            "from perfbench import harness; "
            "sys.exit(harness.main(sys.argv[1:], 0.0, %r))"
            % (CELLS[0], ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
