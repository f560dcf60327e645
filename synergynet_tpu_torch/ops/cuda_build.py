"""Build a kernel source under ``csrc/`` with nvcc and load it with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point (pointers and the
CUDA stream as ``void*``, returning ``cudaGetLastError()``), so it compiles
with nvcc alone in seconds, without PyTorch's headers. The shared library
goes to :func:`synergynet_tpu_torch.core.paths.build_dir`, named by a hash
of its source and flags, so an edited source never loads a stale build.
The build happens at first use, never at import.

Every kernel wrapper launches its entries through :func:`launch`, which
counts each successful launch in :data:`launches` by its C symbol; a
captured program credits the table on every replay
(:mod:`synergynet_tpu_torch.pipeline.program`).
"""

from __future__ import annotations

import collections
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
_ENTRIES: dict = {}

# Launches per C symbol ("synergy_fused_decode", ...), and the attention's
# SDPA calls under "attention".
launches: collections.Counter = collections.Counter()


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


def kernel_entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``csrc/<name>.cu`` (built and loaded by
    :func:`load_kernel_library`) as a ctypes function taking ``argtypes``
    and returning an int, bound once per process: a launch pays a dict
    lookup, not the ctypes setup."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load_kernel_library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


def launch(library: str, symbol: str, argtypes, device, *args) -> None:
    """Launch the C entry ``symbol`` of ``csrc/<library>.cu`` on
    ``device``'s current stream: ``args`` as ``argtypes`` take them (a
    tensor passes its data pointer, None a null pointer, an int or a float
    itself), then the stream. Raises ``RuntimeError`` when the entry
    returns a CUDA error; counts a launch in ``launches[symbol]``."""
    import torch

    fn = kernel_entry(library, symbol, (*argtypes, ctypes.c_void_p))
    values = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(device):
        rc = fn(*values, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kernel {symbol} failed: CUDA error {rc}")
    launches[symbol] += 1


def check_tensor(name: str, t, dtypes, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` whose dtype is
    one of ``dtypes`` and whose shape is ``shape`` (``None`` matches any
    extent): what a kernel's plain C entry takes on trust."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes one of "
                        f"{dtypes}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple('*' if s is None else s for s in shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def require_sm90(device, what: str) -> None:
    """Raise unless ``device`` is a Hopper card, which the sm_90a builds
    need."""
    import torch

    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the {what} kernel is built for sm_90a; {device} is "
            f"{torch.cuda.get_device_name(device)} (capability {cap})")


def build_info(name: str) -> dict:
    """Build seconds (0.0 when an existing build was loaded), library path
    and the ptxas resource lines of a loaded kernel library (registers,
    static shared memory, stack and spills)."""
    info = dict(_LOADED[name][1])
    with open(info["log"]) as f:
        info["ptxas"] = [ln.strip() for ln in f
                         if "ptxas" in ln or "spill" in ln]
    return info
