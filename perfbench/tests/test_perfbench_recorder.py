"""The readers of the program's own measurement (``perfbench/stages.py``
and the metrics that call it): the right value from a recorder the test
fills, and None from an empty recorder or a program without one."""

import os
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, stages

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STAGES = ("copy_in", "detect", "select", "crop", "regress", "decode",
          "clone_out")
STAGE_METRICS = [f"stage_{s}_ms.batch" for s in STAGES]
METRICS = STAGE_METRICS + ["copy_gb.batch", "capture_s.batch"]
KEY = "process_batch.b2"


def _rec():
    return SimpleNamespace(traffic={"frames_per_call": 2, "trace_calls": 3},
                           trace={"calls": 3})


def _filled():
    """A recorder with: one untraced row, then 4 traced calls whose rows
    hold known stamps (stage i of call c lasts (i + 1) * c ms); a program
    of 2 calls; two set-up spans."""
    from synergynet_tpu_torch.core import profiling
    r = profiling.Recorder()
    st = r.program(KEY, "test#1", "cpu", STAGES, frames_per_call=2)
    seq = st.sequence

    def body():
        seq.begin(r.current_call())
        for s in STAGES:
            seq.done(s)

    body()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(4):
            with r.span("synergy.process_batch"):
                body()
    for c in range(1, 5):
        t = [0]
        for i in range(len(STAGES)):
            t.append(t[-1] + (i + 1) * c * 1_000_000)
        seq.ring[c] = torch.tensor(t)
    st.calls, st.bytes_in, st.bytes_out = 2, 2 * 3_000_000_000, 2 * 60_000_000
    for name in stages.SETUP_SPANS:
        with r.setup_span(name):
            pass
    return r


@pytest.mark.parametrize("i,metric", list(enumerate(STAGE_METRICS)))
def test_stage_reader_takes_the_traced_calls(monkeypatch, i, metric):
    """The median over the last ``trace_calls`` traced rows (calls 2-4:
    3 ms), not the untraced row nor call 1."""
    r = _filled()
    monkeypatch.setattr(stages, "recorder", lambda: r)
    got = harness.load_module(ROOT, "metrics", metric).read(_rec())
    assert got == pytest.approx((i + 1) * 3.0)


def test_copy_and_capture_readers(monkeypatch):
    r = _filled()
    monkeypatch.setattr(stages, "recorder", lambda: r)
    read = {m: harness.load_module(ROOT, "metrics", m).read
            for m in ("copy_gb.batch", "capture_s.batch")}
    assert read["copy_gb.batch"](_rec()) == pytest.approx(3.06)
    want = sum(s.end_ns - s.start_ns for s in r.spans()
               if s.name in stages.SETUP_SPANS) / 1e9
    assert read["capture_s.batch"](_rec()) == pytest.approx(want)
    assert want > 0


@pytest.mark.parametrize("metric", METRICS)
def test_reader_of_an_empty_recorder_or_none(monkeypatch, metric):
    from synergynet_tpu_torch.core import profiling
    read = harness.load_module(ROOT, "metrics", metric).read
    monkeypatch.setattr(stages, "recorder", profiling.Recorder)
    assert read(_rec()) is None
    monkeypatch.setattr(stages, "recorder", lambda: None)
    assert read(_rec()) is None


def test_a_program_without_a_recorder_gives_none(monkeypatch):
    from synergynet_tpu_torch.core import profiling
    monkeypatch.delattr(profiling, "recorder")
    assert stages.recorder() is None
    for m in METRICS:
        assert harness.load_module(ROOT, "metrics", m).read(_rec()) is None
