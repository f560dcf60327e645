"""Build a kernel source under ``csrc/`` with nvcc and load it with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point (pointers and the
CUDA stream as ``void*``, returning ``cudaGetLastError()``), so it compiles
with nvcc alone in seconds, without PyTorch's headers. The shared library
goes to :func:`synergynet_tpu_torch.core.paths.build_dir`, named by a hash
of its source and flags, so an edited source never loads a stale build.
The build happens at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

from synergynet_tpu_torch.core.paths import build_dir

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")

# sm_90a: Hopper with its architecture-specific features (wgmma, setmaxnreg).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"nvcc not found at {path}; set CUDA_HOME to the CUDA toolkit")
    return path


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` for sm_90a unless a build of the same
    source exists, then load it. Raises with nvcc's output when the build
    fails. ``build_info(name)`` reports the build seconds and ptxas lines."""
    if name in _LOADED:
        return _LOADED[name][0]
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()
                              ).hexdigest()[:16]
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"lib{name}-{digest}.so")
    log_path = lib_path + ".log"
    seconds = 0.0
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        with open(log_path, "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    _LOADED[name] = (lib, {"seconds": seconds, "path": lib_path,
                           "log": log_path})
    return lib


def build_info(name: str) -> dict:
    """Build seconds (0.0 when an existing build was loaded), library path
    and the ptxas resource lines of a loaded kernel library."""
    info = dict(_LOADED[name][1])
    with open(info["log"]) as f:
        info["ptxas"] = [ln.strip() for ln in f if "ptxas" in ln]
    return info
