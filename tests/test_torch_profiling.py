"""``core/profiling.py``: the device's busy time read out of a Chrome trace,
a profiled window of calls, ``trace`` / ``annotate``, ``StageTimer``,
``measure`` and ``device_memory_stats`` on the CPU."""

import json
import os
import time

import pytest
import torch

from synergynet_tpu_torch.core.profiling import (StageTimer, annotate,
                                                 device_busy,
                                                 device_memory_stats,
                                                 measure, profile_calls,
                                                 trace)

torch.set_num_threads(2)


def _ev(cat, ts, dur, name="k"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}


def test_device_busy_unions_overlapping_intervals():
    events = [
        _ev("kernel", 0, 10, "a"),
        _ev("kernel", 5, 10, "b"),        # overlaps a: counts once
        _ev("gpu_memcpy", 30, 4, "copy"),
        _ev("gpu_memset", 32, 1, "set"),  # inside the copy
        _ev("cpu_op", 0, 100, "host"),    # host work is not device time
        {"ph": "i", "cat": "kernel", "ts": 50, "name": "instant"},
    ]
    d = device_busy(events)
    assert d["busy_us"] == 15 + 4
    assert d["ops"] == 4
    assert d["per_op_us"] == {"a": 10, "b": 10, "copy": 4, "set": 1}


def test_device_busy_of_no_device_work_is_zero():
    assert device_busy([_ev("cpu_op", 0, 9)]) == {
        "busy_us": 0.0, "ops": 0, "per_op_us": {}}


@pytest.mark.parametrize("n", [1, 3])
def test_profile_calls_on_cpu_writes_a_trace(tmp_path, n):
    x = torch.ones(64, 64)
    calls = []

    def fn():
        calls.append(1)
        return x @ x

    path = str(tmp_path / "trace.json")
    p = profile_calls(fn, n, path)
    assert len(calls) == n + 1                  # one warm-up, n profiled
    with open(path) as f:
        json.load(f)
    assert p["wall_ms"] > 0
    assert p["busy_ms"] == 0 and p["ops"] == 0  # no device here
    assert p["idle_share"] == 1.0
    assert p["top"] == []


def test_stage_timer_on_the_host_clock():
    t = StageTimer(device="cpu")
    for _ in range(3):
        with t.stage("sleep"):
            time.sleep(0.01)
    with t.stage("noop"):
        pass
    assert t.counts == {"sleep": 3, "noop": 1}
    avg = t.averages()
    assert 0.009 <= avg["sleep"] < 0.5 and avg["noop"] < avg["sleep"]
    assert abs(t.totals["sleep"] - 3 * avg["sleep"]) < 1e-12
    assert "sleep: total" in t.report() and "over 3 call(s)" in t.report()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            StageTimer()


def test_measure_times_calls_after_warm_up():
    calls = []
    r = measure(lambda x, y=0: calls.append(x + y) or time.sleep(0.002),
                1, iters=5, warmup=2, y=2)
    assert calls == [3] * 7
    assert 0.002 <= r["sec_per_call"] < 0.5
    assert abs(r["calls_per_sec"] * r["sec_per_call"] - 1) < 1e-9


def test_trace_writes_annotated_spans(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("my_span"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "my_span" for e in events)
    assert device_memory_stats("cpu") == {}
