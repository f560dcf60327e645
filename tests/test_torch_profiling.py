"""``core/profiling.py``: ``trace`` / ``annotate``, ``StageTimer`` and
``device_memory_stats`` on the CPU; the recorder's spans, stage stamps and
counters, alone and in the serving engine's CPU body; the launch table of
``ops/cuda_build.py``, which the captured programs credit and no kernel
wrapper bypasses."""

import ast
import collections
import json
import os
import sys
import time

import pytest
import torch

import numpy as np

from synergynet_tpu_torch.core.profiling import (RING_ROWS, StageTimer,
                                                 annotate,
                                                 device_memory_stats,
                                                 recorder, stage_done, tally,
                                                 trace)
from synergynet_tpu_torch.detect.nms import greedy_nms_mask
from synergynet_tpu_torch.detect.stem_fused import fused_stem1_s2d8
from synergynet_tpu_torch.mm3d import load_param_pack
from synergynet_tpu_torch.nn.attention import attention
from synergynet_tpu_torch.ops.cuda_build import launches
from synergynet_tpu_torch.ops.fused_decode import (decode_dense_fast,
                                                   decode_dense_fused)
from synergynet_tpu_torch.ops.split_attention import (radix_combine,
                                                      radix_pool)
from synergynet_tpu_torch.pipeline import program
from synergynet_tpu_torch.pipeline.device_crop import crop_resize_bilinear
from synergynet_tpu_torch.pipeline.program import ProgramCache
from synergynet_tpu_torch.render.raster_tiled import (rasterize_mesh,
                                                      rasterize_mesh_ids)

torch.set_num_threads(2)


def test_program_module_imports_no_kernel_wrapper():
    """The captured programs reach the kernels only through the launch
    table: ``pipeline/program.py`` imports torch, the standard library,
    ``core.profiling`` and ``ops.cuda_build``, and no kernel wrapper."""
    allowed = {"synergynet_tpu_torch.core.profiling",
               "synergynet_tpu_torch.ops.cuda_build"}
    with open(program.__file__) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import"
            names.append(node.module)
    assert "synergynet_tpu_torch.ops.cuda_build" in names
    for name in names:
        top = name.split(".")[0]
        assert top == "torch" or top in sys.stdlib_module_names \
            or name in allowed, name


def _mesh():
    verts = torch.tensor([[1.0, 1.0, 0.5], [6.0, 1.5, 0.5], [3.0, 6.0, 0.5]])
    return verts, torch.tensor([[0, 1, 2]], dtype=torch.int32)


# Each kernel wrapper and a call of its CPU twin at a tiny size.
WRAPPERS = {
    "C1": (crop_resize_bilinear, lambda: crop_resize_bilinear(
        torch.rand(1, 8, 8, 3), torch.tensor([[[1.0, 1.0, 6.0, 6.0]]]), 4)),
    "R1 pool": (radix_pool, lambda: radix_pool(torch.rand(1, 16, 3, 3), 2)),
    "R1 combine": (radix_combine, lambda: radix_combine(
        torch.rand(1, 16, 3, 3), torch.rand(1, 16, 1, 1), 2, 1)),
    "B1": (decode_dense_fused, lambda: decode_dense_fast(
        torch.zeros(1, 62), load_param_pack())),
    "N1": (greedy_nms_mask, lambda: greedy_nms_mask(
        torch.tensor([[[0.0, 0.0, 4.0, 4.0], [1.0, 1.0, 4.0, 4.0]]]),
        torch.ones(1, 2, dtype=torch.bool))),
    "B4": (fused_stem1_s2d8, lambda: fused_stem1_s2d8(
        torch.rand(1, 2, 2, 192), torch.rand(4, 192, 192), torch.rand(192))),
    "B2": (rasterize_mesh, lambda: rasterize_mesh(
        *_mesh(), torch.rand(3, 2), h=8, w=8)),
    "B3": (rasterize_mesh_ids, lambda: rasterize_mesh_ids(
        *_mesh(), h=8, w=8, w0=True)),
    "attention": (attention, lambda: attention(
        *torch.rand(3, 1, 2, 4, 8))),
}


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_wrappers_keep_no_launch_attribute(kernel):
    """Launches are counted in one table, keyed by the C symbol, and in no
    attribute of a wrapper. On the CPU each wrapper runs its twin and
    launches nothing; the attention counts its call."""
    fn, call = WRAPPERS[kernel]
    assert not hasattr(fn, "launches")
    before = launches.copy()
    call()
    want = before + collections.Counter(
        {"attention": 1} if kernel == "attention" else {})
    assert launches == want


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


def test_trace_writes_annotated_spans(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("my_span"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "my_span" for e in events)
    assert device_memory_stats("cpu") == {}


# -- spans --------------------------------------------------------------------

def _cpu_profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_span_without_a_profiler_records_nothing(monkeypatch):
    """With no profiler running a span is the shared null context: no
    ``record_function``, no record, no call number."""
    recorder.reset()

    def no_record_function(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        no_record_function)
    monkeypatch.setattr(torch.profiler, "record_function",
                        no_record_function)
    with annotate("synergy.outer"):
        with annotate("synergy.inner"):
            pass
    assert annotate("synergy.outer") is annotate("synergy.inner")
    assert recorder.spans() == []
    assert recorder.current_call() is None


def test_spans_under_a_profiler_nest_and_share_their_call(tmp_path):
    recorder.reset()
    with trace(str(tmp_path)) as prof:
        for _ in range(2):
            with annotate("synergy.outer"):
                with annotate("synergy.mid"):
                    with annotate("synergy.inner"):
                        torch.ones(8, 8) @ torch.ones(8, 8)
                with annotate("synergy.after"):
                    pass
    spans = recorder.spans()
    assert [s.name for s in spans] == [
        "synergy.inner", "synergy.mid", "synergy.after",
        "synergy.outer"] * 2
    first, second = spans[:4], spans[4:]
    assert {s.call for s in first} == {1} and {s.call for s in second} == {2}
    by = {s.name: s for s in first}
    assert by["synergy.inner"].parent == "synergy.mid"
    assert by["synergy.mid"].parent == "synergy.outer"
    assert by["synergy.after"].parent == "synergy.outer"
    assert by["synergy.outer"].parent is None
    for s in first:
        assert by["synergy.outer"].start_ns <= s.start_ns <= s.end_ns <= \
            by["synergy.outer"].end_ns
    with open(prof.trace_path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    for name in ("synergy.outer", "synergy.mid", "synergy.inner",
                 "synergy.after"):
        assert names.count(name) == 2
    assert recorder.current_call() is None


def test_set_up_span_is_recorded_without_a_profiler():
    recorder.reset()
    with recorder.setup_span("synergy.capture"):
        time.sleep(0.002)
    s, = recorder.spans()
    assert s.name == "synergy.capture" and s.call is None
    assert s.parent is None
    assert s.end_ns - s.start_ns >= 2_000_000


# -- stage stamps and counters of a synthetic program -------------------------

STAGES = ("copy_in", "a", "b", "clone_out")


def _body(x):
    stage_done("a")
    tally(lambda: ((x > 0).sum(),))
    stage_done("b")
    return (x + 1,)


def _cache():
    return ProgramCache(torch.device("cpu"), "test")


def _run(cache, key, x):
    return cache.run(key, _body, x, stages=STAGES, tallies=("n",))


def _record(cache, key):
    st, = recorder.programs(key, cache.engine)
    return st


@pytest.mark.parametrize("n", [1, RING_ROWS, RING_ROWS + 1])
def test_stage_ring_wraps(n):
    """After ``n`` calls the ring holds the last ``min(n, 64)`` rows in
    order: each row's stamps lie inside its own call and rise."""
    key = f"test.wrap{n}"
    recorder.reset()
    cache = _cache()
    bounds = []
    for _ in range(n):
        t0 = time.perf_counter_ns()
        _run(cache, key, torch.ones(3))
        bounds.append((t0, time.perf_counter_ns()))
    seq = _record(cache, key).sequence
    rows, tallies = seq.read()
    assert len(rows) == min(n, RING_ROWS) and seq.done_rows == n
    assert int(seq.row) == n and tallies == [3 * n]
    for (call, stamps), (t0, t1) in zip(rows, bounds[n - len(rows):]):
        assert call is None
        assert len(stamps) == len(STAGES) + 1
        assert t0 <= stamps[0] and stamps[-1] <= t1
        assert stamps == sorted(stamps)
    ms = recorder.stage_rows(key)
    assert len(ms) == len(rows) and list(ms[0][1]) == list(STAGES)


def test_stage_ms_takes_the_rows_of_given_calls():
    key = "test.calls"
    recorder.reset()
    cache = _cache()
    _run(cache, key, torch.ones(2))         # no profiler: no call number
    with _cpu_profiler():
        for _ in range(3):
            with annotate("synergy.call"):
                _run(cache, key, torch.ones(2))
    rows = recorder.stage_rows(key)
    assert [c for c, _ in rows] == [None, 1, 2, 3]
    assert recorder.stage_ms(key, calls={2, 3}) == {
        s: pytest.approx(np.median([rows[2][1][s], rows[3][1][s]]))
        for s in STAGES}
    assert recorder.stage_ms(key, last=1) == rows[3][1]
    assert recorder.stage_ms(key, calls={9}) is None
    assert recorder.stage_ms("test.never") is None
    assert recorder.counters("test.never") is None


def test_stage_outside_a_stamped_body_stamps_nothing():
    """A body called directly stamps nothing and never computes its
    tallies."""
    key = "test.outside"
    recorder.reset()
    cache = _cache()
    _run(cache, key, torch.ones(2))
    seq = _record(cache, key).sequence
    before = seq.buf.clone()
    _body(torch.ones(2))
    stage_done("a")
    tally(lambda: pytest.fail("tallies computed outside a stamped body"))
    assert torch.equal(seq.buf, before) and seq.done_rows == 1


def test_each_engine_keeps_its_own_program_record():
    """Two engines serving one key stamp their own rings; counters sum
    over them or narrow to one engine."""
    key = "test.engines"
    recorder.reset()
    one, two = _cache(), _cache()
    assert one.engine != two.engine
    _run(one, key, torch.ones(2))
    for _ in range(2):
        _run(two, key, torch.ones(4))
    assert _record(one, key).sequence.read()[1] == [2]
    assert _record(two, key).sequence.read()[1] == [8]
    assert len(recorder.stage_rows(key, one.engine)) == 1
    assert len(recorder.stage_rows(key)) == 3
    assert recorder.counters(key, two.engine)["calls"] == 2
    both = recorder.counters(key)
    assert both["calls"] == 3 and both["n"] == 10 and both["frames"] == 10
    assert recorder.counters(key, "test#0") is None
    for dev, n in (("cuda:0", 2), ("cuda:1", 3)):
        st = recorder.program("test.devices", f"test#{n}", dev)
        st.calls, st.bytes_in = n, 10 * n
    assert st.device == "cuda:1"
    assert recorder.counters("test.devices", "test#3")["calls"] == 3
    assert recorder.counters("test.devices")["bytes_in"] == 50


def test_tally_needs_one_value_per_name():
    recorder.reset()
    cache = _cache()
    with pytest.raises(ValueError, match="tallies"):
        cache.run("test.tallies", _body, torch.ones(2), stages=STAGES,
                  tallies=("n", "m"))


# -- the serving engine's CPU body --------------------------------------------

@pytest.fixture(scope="module")
def cpu_engine():
    from synergynet_tpu_torch.detect.detector import (FaceBoxes,
                                                      random_init_variables)
    from synergynet_tpu_torch.pipeline import (FusedFrameEngine,
                                               SynergyNet3DMM)
    api = SynergyNet3DMM(variables="trained", device="cpu")
    det = FaceBoxes(random_init_variables(0), device="cpu")
    return FusedFrameEngine(api, detector=det, max_faces=2)


def _frames(b, seed):
    from synergynet_tpu_torch.detect.detector import prepare_frame
    rng = np.random.default_rng(seed)
    packs = [prepare_frame(rng.integers(0, 256, (720, 1088, 3), np.uint8),
                           8, "cpu") for _ in range(b)]
    return tuple(torch.stack([p[i] for p in packs]) for i in range(3))


def test_process_batch_stamps_one_whole_row(cpu_engine):
    """A CPU ``process_batch`` call runs ``process_batch_eager`` under its
    program, which leaves one row of eight stamps in order."""
    from synergynet_tpu_torch.pipeline.api import BATCH_STAGES
    recorder.reset()
    t0 = time.perf_counter_ns()
    cpu_engine.process_batch(*_frames(1, 3))
    t1 = time.perf_counter_ns()
    seq = _record(cpu_engine.programs, "process_batch.b1").sequence
    assert seq.stages == BATCH_STAGES
    (call, stamps), = seq.read()[0]
    assert len(stamps) == 8 and stamps == sorted(stamps)
    assert t0 <= stamps[0] and stamps[-1] <= t1
    (_, ms), = recorder.stage_rows("process_batch.b1",
                                   cpu_engine.programs.engine)
    assert list(ms) == list(BATCH_STAGES)
    assert ms["detect"] > 0 and ms["regress"] > 0


def test_a_stage_called_alone_leaves_the_ring(cpu_engine):
    """A direct ``regress`` (or detect or select, or the whole eager body)
    call stamps and tallies nothing."""
    frames, s2d, hws = _frames(1, 4)
    out = cpu_engine.process_batch(frames, s2d, hws)
    seq = _record(cpu_engine.programs, "process_batch.b1").sequence
    before, done = seq.buf.clone(), seq.done_rows
    with torch.inference_mode():
        cpu_engine.regress(frames, out[2])
        scores, boxes = cpu_engine.detect_candidates(s2d, hws)
        cpu_engine.select_faces(scores, boxes)
        cpu_engine.process_batch_eager(frames, s2d, hws)
    assert torch.equal(seq.buf, before) and seq.done_rows == done


def test_counters_after_two_calls(cpu_engine):
    """frames = 2B, valid >= kept >= faces = the faces served, and the
    bytes in and out are the inputs' and outputs' sizes."""
    recorder.reset()
    b = 2
    served, nbytes = 0, [0, 0]
    for seed in (5, 6):
        args = _frames(b, seed)
        out = cpu_engine.process_batch(*args)
        served += int(out[1].sum())
        for i, xs in enumerate((args, out)):
            nbytes[i] += sum(x.numel() * x.element_size() for x in xs)
    c = recorder.counters(f"process_batch.b{b}", cpu_engine.programs.engine)
    assert c["calls"] == 2 and c["frames"] == 2 * b
    assert c["valid"] >= c["kept"] >= c["faces"] == served > 0
    assert [c["bytes_in"], c["bytes_out"]] == nbytes
    assert c["captures"] == 0
    assert recorder.stage_rows(f"process_batch.b{b}")[-1][0] is None
