"""The port stands without JAX: every slice module imports in a process
where ``import jax`` fails, and no port source names jax."""

import os
import re
import subprocess
import sys

import pytest
import torch

import synergynet_tpu_torch

torch.set_num_threads(2)

PKG = os.path.dirname(synergynet_tpu_torch.__file__)

MODULES = [
    "synergynet_tpu_torch",
    "synergynet_tpu_torch.core.paths",
    "synergynet_tpu_torch.core.checkpoint",
    "synergynet_tpu_torch.core.profiling",
    "synergynet_tpu_torch.mm3d",
    "synergynet_tpu_torch.ops",
    "synergynet_tpu_torch.ops.cuda_build",
    "synergynet_tpu_torch.nn",
    "synergynet_tpu_torch.convert",
    "synergynet_tpu_torch.detect",
    "synergynet_tpu_torch.pipeline",
]


def test_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['flax'] = None\n"
            "sys.modules['synergynet_tpu'] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.dirname(PKG)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("root", ["synergynet_tpu_torch", "chip_smoke.py"])
def test_no_jax_import_in_sources(root):
    path = os.path.join(os.path.dirname(PKG), root)
    files = ([path] if path.endswith(".py") else
             [os.path.join(d, f) for d, _, fs in os.walk(path)
              for f in fs if f.endswith(".py")])
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|synergynet_tpu)\b",
                     re.M)
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f
