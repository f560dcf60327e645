"""Run a function on every rank of a fresh multi-process job.

    results = run_ranks("pkg.module:function", world=2, workdir=d,
                        kwargs={...}, backend="gloo")

starts ``world`` processes of ``python -m synergynet_tpu_torch.parallel.
launch``, each of which joins the job (:func:`init_distributed`, the
rendezvous a ``file://`` path in ``workdir``, so concurrent jobs on one
host cannot collide on a port), calls ``function(**kwargs)`` and saves
what it returns (tensors, numpy arrays and plain Python values) for the
parent. Every child runs one intra-op thread; the parent waits at most
``timeout`` seconds for all of them and kills any that are left, also on
failure. A child imports only what the function's module imports.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
import traceback
from typing import List, Optional

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_ranks(target: str, world: int, workdir: str,
              kwargs: Optional[dict] = None, backend: str = "gloo",
              timeout: float = 120.0) -> List[object]:
    """``target`` ("module:function") on ``world`` ranks; returns each
    rank's result, rank 0 first. Raises ``RuntimeError`` with the failing
    ranks' output if a rank fails, ``TimeoutError`` past ``timeout``."""
    os.makedirs(workdir, exist_ok=True)
    rendezvous = os.path.join(workdir, "rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    with open(os.path.join(workdir, "kwargs.json"), "w") as f:
        json.dump(kwargs or {}, f)
    child_env = dict(os.environ)
    child_env["OMP_NUM_THREADS"] = "1"
    child_env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in child_env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    procs, logs = [], []
    try:
        for rank in range(world):
            log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "synergynet_tpu_torch.parallel.launch",
                 target, str(world), str(rank), f"file://{rendezvous}",
                 backend, workdir],
                stdout=log, stderr=subprocess.STDOUT, env=child_env))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.01))
            except subprocess.TimeoutExpired:
                raise TimeoutError(
                    f"{target} on {world} ranks: not done in {timeout} s"
                    + _tails(workdir, world)) from None
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"{target}: ranks {bad} failed"
                               + _tails(workdir, world))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _tails(workdir: str, world: int, n: int = 3000) -> str:
    out = []
    for r in range(world):
        path = os.path.join(workdir, f"rank{r}.log")
        if os.path.exists(path):
            with open(path) as f:
                out.append(f"\n--- rank {r} ---\n" + f.read()[-n:])
    return "".join(out)


def _child(target, world, rank, init, backend, workdir) -> None:
    torch.set_num_threads(1)
    from synergynet_tpu_torch.parallel import init_distributed
    import torch.distributed as dist
    mod, fn = target.split(":")
    with open(os.path.join(workdir, "kwargs.json")) as f:
        kwargs = json.load(f)
    init_distributed(init, world, rank, backend=backend)
    try:
        result = getattr(importlib.import_module(mod), fn)(**kwargs)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    try:
        a = sys.argv[1:]
        _child(a[0], int(a[1]), int(a[2]), a[3], a[4], a[5])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
