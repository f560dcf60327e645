"""Profiling: device traces, named spans, stage timers, busy time.

Counterpart, for the card, of ``synergynet_tpu/core/profiling.py``
(``:27-107``):

- :func:`trace` records the enclosed region under ``torch.profiler`` (CPU
  and, where there is a card, CUDA activity) and writes a Chrome trace
  into a directory; :func:`annotate` names a span in it (and an NVTX range
  on the card);
- :class:`StageTimer` times named stages: CUDA events on the card, the
  host clock on the CPU; :func:`measure` times a callable's calls after
  warm-up; :func:`device_memory_stats` reads the card's allocator;
- :func:`profile_calls` runs a callable under the profiler and reads the
  device's work back out of the trace with :func:`device_busy`.

The JAX package's ``enable_compile_cache`` has no counterpart: nothing of
the port is compiled by XLA.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from synergynet_tpu_torch.core.device import resolve_device

def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed region under ``torch.profiler`` and write its
    Chrome trace to ``log_dir/trace_<pid>_<ns>.json`` (open it in Perfetto
    or ``chrome://tracing``); the path is the profiler's ``trace_path``."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


@contextlib.contextmanager
def annotate(name: str):
    """A named span in device traces: ``record_function`` for the profiler
    and, where there is a card, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StageTimer:
    """Accumulating per-stage timer on ``device`` (the card unless the
    caller asks for the CPU): CUDA events around each stage on the card,
    read when the totals are asked for (one synchronize then); the host
    clock on the CPU.

    >>> t = StageTimer()
    >>> with t.stage("decode"):
    ...     out = decode(...)          # device work
    >>> t.report()
    """

    def __init__(self, sync: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.sync = sync
        self._totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._pending = []

    @contextlib.contextmanager
    def stage(self, name: str):
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
        else:
            t0 = time.perf_counter()
        try:
            yield self
        finally:
            if cuda:
                end.record(torch.cuda.current_stream(self.device))
                self._pending.append((name, start, end))
                if self.sync:
                    self._resolve()
            else:
                self._add(name, time.perf_counter() - t0)

    def _add(self, name: str, seconds: float) -> None:
        self._totals[name] = self._totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def _resolve(self) -> None:
        for name, start, end in self._pending:
            end.synchronize()
            self._add(name, start.elapsed_time(end) / 1e3)
        self._pending.clear()

    @property
    def totals(self) -> Dict[str, float]:
        """Seconds per stage, summed over its calls."""
        self._resolve()
        return self._totals

    def averages(self) -> Dict[str, float]:
        totals = self.totals
        return {k: totals[k] / max(self.counts[k], 1) for k in totals}

    def report(self) -> str:
        return "\n".join(
            f"{k}: total {self._totals[k] * 1e3:.3f} ms over "
            f"{self.counts[k]} call(s), avg {v * 1e3:.3f} ms"
            for k, v in self.averages().items())


def measure(fn: Callable, *args, iters: int = 20, warmup: int = 2,
            **kwargs) -> Dict[str, float]:
    """Seconds per call and calls per second of ``fn(*args, **kwargs)``
    over ``iters`` calls after ``warmup``, the card synchronized (where
    there is one) before and after the timed calls."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    for _ in range(max(warmup, 1)):
        fn(*args, **kwargs)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    sync()
    dt = (time.perf_counter() - t0) / iters
    return {"sec_per_call": dt, "calls_per_sec": 1.0 / dt}


def device_memory_stats(device: Optional[Any] = None) -> Dict[str, int]:
    """The card's allocator counters (``torch.cuda.memory_stats``: live and
    peak bytes, ``allocated_bytes.all.peak`` ...) for a CUDA ``device``
    (the current card when None and there is one); empty for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.cuda.current_device()
    dev = torch.device(device) if not isinstance(device, int) else \
        torch.device("cuda", device)
    if dev.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(dev))


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
    acts = _activities()
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
