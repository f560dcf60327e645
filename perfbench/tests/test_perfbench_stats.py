"""Percentiles over every sample, rates over all the work and time, the
device-interval union and the idle gaps' labels."""

import numpy as np
import pytest

from perfbench import tracing


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_is_over_every_sample(q):
    xs = list(np.random.default_rng(q).exponential(size=1001))
    assert tracing.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_percentile_takes_no_chunk_medians():
    # 99 fast samples and 1 slow one: a median of chunk medians would
    # lose the slow sample's weight in the tail; the p95 of all is 1.
    xs = [1.0] * 99 + [50.0]
    assert tracing.percentile(xs, 50) == 1.0
    assert tracing.percentile(xs, 100) == 50.0


def test_rate_is_all_work_over_all_time():
    assert tracing.rate(1024 * 30, 1.5) == pytest.approx(20480.0)
    with pytest.raises(ValueError):
        tracing.rate(1, 0.0)


def _ev(name, ts, dur, cat="kernel", tid=1):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "tid": tid}


def test_device_busy_counts_overlap_once():
    events = [_ev("a", 0, 10), _ev("b", 5, 10), _ev("c", 30, 5),
              _ev("copy", 33, 4, "gpu_memcpy"),
              _ev("host", 0, 100, "cpu_op")]
    d = tracing.device_busy(events)
    assert d["busy_us"] == 15 + 7
    assert d["ops"] == 4
    assert d["per_op_us"]["a"] == 10


def test_idle_gaps_labelled_by_host_activity():
    events = [_ev("perfbench.call", 0, 100, "user_annotation"),
              _ev("aten::copy_", 20, 20, "cpu_op"),
              _ev("k1", 0, 20), _ev("k2", 40, 50)]
    gaps = tracing.idle_gaps(events, 0, 100)
    assert gaps == {"perfbench.call/aten::copy_": 20,
                    "perfbench.call": 10}


def test_op_seconds_per_call():
    trace = {"calls": 4, "per_op_s": {"stem_kernel<1>": 0.004,
                                      "other": 1.0}}
    assert tracing.op_seconds(trace, "stem_kernel") == pytest.approx(0.001)
    assert tracing.op_seconds(trace, "nms_tile_") is None
    assert tracing.op_seconds(None, "x") is None
