"""``core/profiling.py``: the device's busy time read out of a Chrome trace,
and a profiled window of calls on the CPU."""

import json

import pytest
import torch

from synergynet_tpu_torch.core.profiling import device_busy, profile_calls

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
