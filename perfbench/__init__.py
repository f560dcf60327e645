"""The benchmark of the PyTorch + CUDA port (``synergynet_tpu_torch``):
``python3 perfbench/run.py --workload <cell> ...``; see ``run.py``."""

import importlib.util
import os
import sys


def by_name(package: str, name: str):
    """The module ``<name>.py`` in the folder of the imported package
    ``package`` (as ``perfbench.counts``), found by its file name and
    imported once. A name may hold dots, as the port's architecture names
    do (``mobilenet_1_0.5``)."""
    key = f"{package}.{name.replace('.', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(os.path.dirname(sys.modules[package].__file__),
                        f"{name}.py")
    if not os.path.exists(path):
        raise ValueError(f"no {name!r} in {package}: no {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod
