"""Nothing the run imports or runs is JAX or the JAX package (top-level
names compared whole: the port's name starts with the JAX package's), and
the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PB = os.path.join(ROOT, "perfbench")


def _sources(folder):
    for d, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources(PB)))
def test_no_file_imports_jax(path):
    assert not set(_imports(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(
    PB, "reference"))))
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "contextlib", "math",
                                   "typing", "numpy", "torch", "perfbench"}
    for line in open(path):
        assert "synergynet_tpu" not in line.split("#")[0].replace(
            "``", "") or "import" not in line


def test_a_run_loads_no_jax():
    """A whole run on the CPU, in a fresh process: the modules loaded at
    its end hold no forbidden top-level name."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from perfbench import harness\n"
        "out = harness.run_cell(%r, 'mbv2.b128', 1, 0.1, False, 0.0, "
        "device='cpu', traffic_override={'frames_per_call': 1, 'ring': 1,"
        " 'check_calls': 1, 'check_rounds': 1})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % (ROOT, ROOT)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, check=True)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "synergynet_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)
