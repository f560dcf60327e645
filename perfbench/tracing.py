"""Statistics of a run and the reading of its device trace.

``device_busy`` and the device categories are copied from the program's
``core/profiling.py`` (sound there: the union of the device intervals,
streams overlapping once), so that a later change to the program cannot
move this yardstick. Percentiles and rates are over every sample and all
the time of a window: no statistic of chunks.
"""

from __future__ import annotations

import collections
import json
import math
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation", "cuda_driver")


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, linearly
    interpolated between the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(units: float, seconds: float) -> float:
    """All the work of a window over all its time."""
    if seconds <= 0:
        raise ValueError("a window has positive length")
    return units / seconds


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


def idle_gaps(events: List[dict], t0: float, t1: float) -> Dict[str, float]:
    """Microseconds with no device op in [t0, t1], summed by what the host
    was doing: the innermost host event of the benchmark's thread open at
    each gap's middle, under the benchmark's span around it."""
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in DEVICE_CATS)
    spans = [e for e in events if e["name"].startswith("perfbench.")]
    tid = spans[0].get("tid") if spans else None
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and e.get("tid") == tid), key=lambda e: e["ts"])
    gaps, end = [], t0
    for s, e in dev:
        if s > end:
            gaps.append((end, min(s, t1)))
        end = max(end, e)
    if end < t1:
        gaps.append((end, t1))
    out: Dict[str, float] = collections.Counter()
    active: List[dict] = []
    i = 0
    for s, e in sorted(g for g in gaps if g[1] > g[0]):
        mid = (s + e) / 2
        while i < len(host) and host[i]["ts"] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h["ts"] + h["dur"] >= mid]
        inner = min(active, key=lambda h: h["dur"], default=None)
        outer = [h for h in active if h["name"].startswith("perfbench.")]
        label = inner["name"] if inner else "no host event"
        if outer and inner is not outer[0]:
            label = f"{outer[0]['name']}/{label}"
        out[label] += e - s
    return dict(out)


def traced_window(torch, fn, n: int, path: str) -> Dict:
    """``fn(k)`` for k < ``n`` under ``torch.profiler`` (host and device),
    each call inside the span ``perfbench.call`` -> the window's wall
    seconds (device synchronised at its end), its device events, the
    busy union, the ops by time, the idle gaps by host activity. The
    Chrome trace goes to ``path`` and is deleted once read."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(n):
            with torch.profiler.record_function("perfbench.call"):
                fn(k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    calls = [e for e in events if e["name"] == "perfbench.call"]
    t_start = min(e["ts"] for e in calls)
    t_end = max(e["ts"] + e["dur"] for e in events)
    busy = device_busy(events)
    return {"wall_s": wall, "calls": n, "busy_s": busy["busy_us"] / 1e6,
            "ops": busy["ops"],
            "per_op_s": {k: v / 1e6 for k, v in busy["per_op_us"].items()},
            "idle_s": {k: v / 1e6 for k, v in
                       idle_gaps(events, t_start, t_end).items()}}


def op_seconds(trace: Optional[Dict], fragment: str) -> Optional[float]:
    """Device seconds of the ops whose name holds ``fragment`` per traced
    call, or None when the trace has none."""
    if not trace:
        return None
    s = sum(v for k, v in trace["per_op_s"].items() if fragment in k)
    return s / trace["calls"] if s > 0 else None


def top(d: Dict[str, float], n: int = 10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
