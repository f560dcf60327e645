"""Device traces: busy time, idle share and the leading device ops.

Counterpart, for the card, of ``synergynet_tpu/core/profiling.py``'s
``trace``. :func:`profile_calls` runs a callable under ``torch.profiler``
(CPU and, where there is a card, CUDA activity), writes the Chrome trace
and reads the device's work back out of it with :func:`device_busy`.
"""

from __future__ import annotations

import collections
import json
import time
from typing import Callable, Dict, Iterable

import torch

# Chrome-trace categories of work that occupies the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(events: Iterable[dict]) -> Dict:
    """Chrome-trace events -> ``{"busy_us", "ops", "per_op_us"}``: the
    union of the device intervals (overlapping streams count once), how
    many device ops ran, and each op name's summed duration."""
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    busy, end = 0.0, float("-inf")
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if e > end:
            busy += e - max(s, end)
            end = e
    per_op = collections.Counter()
    for e in dev:
        per_op[e["name"]] += e["dur"]
    return {"busy_us": busy, "ops": len(dev), "per_op_us": dict(per_op)}


def profile_calls(fn: Callable[[], object], n: int, trace_path: str,
                  top: int = 10) -> Dict:
    """Run ``fn()`` once to warm up, then ``n`` times under the profiler.

    Writes the Chrome trace to ``trace_path`` and returns per-call
    ``wall_ms`` (host clock over the window, device synchronised at its
    end), ``busy_ms``, ``idle_share`` = 1 - busy / wall, ``ops`` and the
    ``top`` device ops by time as ``[(name, ms per call), ...]``. The
    profiler itself slows the host, so ``wall_ms`` exceeds an unprofiled
    call's time."""
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    fn()
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    d = device_busy(events)
    wall_ms, busy_ms = wall * 1e3 / n, d["busy_us"] / 1e3 / n
    leaders = sorted(d["per_op_us"].items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "ops": d["ops"] / n,
            "top": [(name, us / 1e3 / n) for name, us in leaders]}
