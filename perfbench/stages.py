"""The program's own measurement, read through its public recorder
(``synergynet_tpu_torch.core.profiling.recorder``): the stage stamps of
its captured ``process_batch`` program, the program's counters and its
set-up spans. Every reader here returns None, and raises nothing, where
the program has no recorder or the recorder has nothing for the cell."""

from __future__ import annotations

from typing import Optional

SETUP_SPANS = ("synergy.warmup", "synergy.capture")


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from synergynet_tpu_torch.core import profiling
    except ImportError:
        return None
    return getattr(profiling, "recorder", None)


def batch_key(rec) -> Optional[str]:
    """The recorder's key of the cell's program: ``process_batch.b<B>``."""
    b = rec.traffic.get("frames_per_call")
    return f"process_batch.b{b}" if b else None


def stage_ms(rec, stage: str) -> Optional[float]:
    """Median device ms of ``stage`` over the ring rows of the traced
    window's calls (those the recorder numbered under the profiler), at
    most ``trace_calls`` of them."""
    r, key = recorder(), batch_key(rec)
    if r is None or key is None or not rec.trace:
        return None
    calls = {s.call for s in r.spans() if s.call is not None}
    ms = r.stage_ms(key, last=rec.traffic.get("trace_calls"), calls=calls)
    return ms.get(stage) if ms else None


def copy_gb(rec) -> Optional[float]:
    """GB copied into the program's static inputs and cloned out of its
    outputs per call (10^9 bytes), over every call of the run."""
    r, key = recorder(), batch_key(rec)
    if r is None or key is None:
        return None
    c = r.counters(key)
    if not c or not c.get("calls"):
        return None
    return (c["bytes_in"] + c["bytes_out"]) / c["calls"] / 1e9


def setup_seconds(rec) -> Optional[float]:
    """Seconds of the set-up spans (warm-up and capture) of every program
    the run built."""
    r = recorder()
    if r is None:
        return None
    spans = [s for s in r.spans() if s.name in SETUP_SPANS]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9
