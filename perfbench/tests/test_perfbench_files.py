"""Configurations, cells and metric readers are files found by name; a
cell is added by adding files alone."""

import inspect
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from perfbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    bench, entry, traffic, cfg = harness.load_cell(ROOT, cell)
    assert cfg["name"] == entry["config"]
    assert os.path.exists(os.path.join(ROOT, "perfbench", "entries",
                                       traffic["entry"] + ".py"))
    assert set(traffic["limits"]) >= {"logit_gap", "geom_err", "pose_err"}
    for m in harness.cell_metrics(bench, cell, trace=False):
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s"
               for m in harness.cell_metrics(bench, cell, trace=False))
    assert harness.cell_metrics(bench, cell, trace=True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]]
                         + [m["name"] for m in BENCH["end_to_end"]
                            if m["name"] != "setup_s"])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.load_module(ROOT, "metrics", metric).read)


def test_configuration_files_match_benchmark():
    for c in BENCH["configs"]:
        cfg = harness.read_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])


def test_new_cell_is_a_file(tmp_path):
    """A copy of the benchmark with one more cell: a workload file and its
    line in BENCHMARK.json, no code. The harness finds it and runs it."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "synergynet_tpu"), root / "synergynet_tpu")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mbv2.b2", "config": "synergy_mbv2",
                               "traffic": "mbv2.b2", "chips": 1,
                               "why": "two canvases a call"})
    bench["end_to_end"][0]["workloads"].append("mbv2.b2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = harness.read_json(os.path.join(
        ROOT, "perfbench", "workloads", "mbv2.b128.json"))
    traffic.update(frames_per_call=2, ring=1, check_calls=1, check_rounds=1)
    (root / "perfbench" / "workloads" / "mbv2.b2.json").write_text(
        json.dumps(traffic))
    out = harness.run_cell(str(root), "mbv2.b2", 3, 0.2, False, 0.0,
                           device="cpu")
    assert set(out["result"]["metrics"]) == {"faces_per_s", "setup_s"}
    assert out["result"]["attempted"] >= 1


def _files(top):
    """Every file under ``top`` (relative paths), bytecode left out."""
    out = set()
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        out |= {os.path.relpath(os.path.join(d, f), top) for f in files}
    return out


def _copy_checkout(tmp_path):
    """A checkout holding ``BENCHMARK.json``, ``perfbench/`` and the
    program, as the benchmark runs in one."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for pkg in ("synergynet_tpu", "synergynet_tpu_torch"):
        os.symlink(os.path.join(ROOT, pkg), root / pkg)
    return root


def _run_in(root, cell, seed):
    """``harness.run_cell`` on the CPU in a fresh process whose
    ``perfbench`` is the checkout's -> the result object."""
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "from perfbench import harness\n"
            "assert harness.__file__.startswith(%r)\n"
            "out = harness.run_cell(%r, %r, %d, 0.2, False, 0.0, "
            "device='cpu')\n"
            "print(json.dumps(out['result']))\n") % (
                str(root), str(root), str(root), cell, seed)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, env=env, cwd=str(root))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_regressor_is_files(tmp_path):
    """A regressor architecture the port has and the benchmark lacks
    (``mobilenet_1``, seeded) added to a copy of the benchmark as new
    files and entries alone: its configuration, ``regressors/`` and
    ``counts/`` modules, a workload and its lines in BENCHMARK.json. The
    copy's run is correct, and no file it had differs."""
    root = _copy_checkout(tmp_path)
    new = os.path.join(ROOT, "perfbench", "tests", "new_regressor")
    added = _files(new)
    assert added and not added & _files(os.path.join(ROOT, "perfbench"))
    for rel in added:
        shutil.copy(os.path.join(new, rel), root / "perfbench" / rel)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({
        "name": "synergy_mbv1", "source": "https://arxiv.org/abs/1704.04861",
        "file": "perfbench/configs/synergy_mbv1.json", "reduced": [],
        "why": "MobileNetV1 1.0, seeded"})
    bench["workloads"].append({"name": "mbv1.b2", "config": "synergy_mbv1",
                               "traffic": "mbv1.b2", "chips": 1,
                               "why": "two canvases a call"})
    bench["end_to_end"][0]["workloads"].append("mbv1.b2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    result = _run_in(root, "mbv1.b2", 5)
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"faces_per_s", "setup_s"}

    got = _files(root / "perfbench")
    assert got == _files(os.path.join(ROOT, "perfbench")) | added
    for rel in got - added:
        with open(root / "perfbench" / rel, "rb") as a, \
                open(os.path.join(ROOT, "perfbench", rel), "rb") as b:
            assert a.read() == b.read(), rel
    back = json.loads((root / "BENCHMARK.json").read_text())
    back["configs"].pop()
    back["workloads"].pop()
    back["end_to_end"][0]["workloads"].remove("mbv1.b2")
    assert back == BENCH


def test_architectures_named_only_in_their_files():
    """No file of the harness or the reference names a regressor
    architecture: only its ``reference/regressors/`` and ``counts/``
    modules (and the tests) do."""
    from perfbench.reference import nets
    pb = os.path.join(ROOT, "perfbench")
    for rel in sorted(_files(pb)):
        if not rel.endswith(".py") or rel.startswith(
                (os.path.join("reference", "regressors", ""),
                 os.path.join("counts", ""), os.path.join("tests", ""))):
            continue
        with open(os.path.join(pb, rel)) as f:
            text = f.read()
        assert "mobilenet_v2" not in text and "resnest50" not in text, rel
    assert not hasattr(nets, "REGRESSORS")


SMALL = {"frames_per_call": 2, "ring": 1, "check_calls": 1,
         "check_rounds": 1}


def test_crop_follows_the_configuration(tmp_path, monkeypatch):
    """``synergy_mbv2`` at ``"crop": 96``: the reference crops, regresses
    and judges at 96, the counts follow, and the program is given 96."""
    import torch

    import synergynet_tpu_torch.pipeline as port
    from perfbench import program, weights
    from perfbench.counts import call_flops, crop, decode, faceboxes
    from perfbench.counts import mobilenet_v2 as mbv2_count
    from perfbench.reference import nets, regressors
    from perfbench.reference import pipeline as P
    from perfbench.reference.judge import judge
    from perfbench.reference.precision import Precision, exact_f32

    root = _copy_checkout(tmp_path)
    path = root / "perfbench" / "configs" / "synergy_mbv2.json"
    cfg = json.loads(path.read_text())
    cfg["regressor"]["crop"] = 96
    path.write_text(json.dumps(cfg))

    # The counts, by hand.
    assert crop.flops(96) == 96 * 96 * 3 * 4 * 2 + 4 * 96 * 4 == 222_720
    assert crop.nbytes(96) == 96 * 96 * 3 * 4 + 16
    assert call_flops(cfg, 128, 1024) == 128 * faceboxes.flops(720, 1088) \
        + 1024 * (mbv2_count.flops(96) + 222_720
                  + decode.flops(1, decode.NVER) + decode.flops(1, 68))
    read = harness.load_module(ROOT, "metrics", "crop_roofline.batch").read
    t_bound = 1024 * (96 * 96 * 3 + 4) * 4 / 3.35e12
    rec = SimpleNamespace(
        trace={"per_op_s": {"crop_bilinear_kernel": 10 * 4 * t_bound},
               "calls": 10},
        traffic={"frames_per_call": 128}, cfg=cfg)
    assert read(rec) == pytest.approx(25.0)

    # The reference: crops of 96 into the net, served and judged at 96.
    run, entry, ref, _, _, _ = harness.setup(str(root), "mbv2.b128", 31,
                                             "cpu", SMALL)
    assert run.cfg["regressor"]["crop"] == 96
    net = regressors.load("mobilenet_v2")
    seen = []
    forward = net.forward

    def spy(p, t, x):
        seen.append(tuple(x.shape[1:]))
        return forward(p, t, x)

    monkeypatch.setattr(net, "forward", spy)
    canvas, hws = entry.canvases([0])
    pack = P.pack_tensors(run.pack_arrays, run.device)
    anc = P.anchors(canvas.shape[1], canvas.shape[2], run.device)
    with exact_f32(), torch.no_grad():
        faces = P.serve(Precision("f32"), run.cfg["regressor"],
                        ref["detector"], ref["regressor"], pack, canvas,
                        hws, run.cfg["max_faces"], anc)
    assert int(faces["n"].sum()) > 0
    at96 = judge(run.cfg["regressor"], ref["detector"], ref["regressor"],
                 pack, canvas, hws, faces)
    assert at96["param_err"] < 1e-6, at96
    at120 = judge(dict(run.cfg["regressor"], crop=120), ref["detector"],
                  ref["regressor"], pack, canvas, hws, faces)
    assert at120["param_err"] > 0.14, at120
    assert set(seen) == {(96, 96, 3), (120, 120, 3)}
    det = weights.draw(nets.faceboxes_spec(), 1, "cpu")
    noise = torch.rand(2, 256, 256, 3, generator=torch.Generator()
                       .manual_seed(1)) * 255
    assert weights._service_crops(det, noise, 96).shape == (64, 96, 96, 3)

    # The program is given the configuration's crop ...
    given = []

    class Api(port.SynergyNet3DMM):
        def __init__(self, *args, crop=120, **kwargs):
            given.append(crop)
            super().__init__(*args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(port, "SynergyNet3DMM", Api)
        program.build(run.cfg, run.program_trees, run.pack_arrays, "cpu")
    assert given == [96]
    # ... and one whose API takes none serves 120 only.
    if "crop" in inspect.signature(port.SynergyNet3DMM).parameters:
        out = harness.run_cell(str(root), "mbv2.b128", 31, 0.2, False, 0.0,
                               device="cpu", traffic_override=SMALL)
        assert out["result"]["correct"], out["check"]
    else:
        with pytest.raises(ValueError, match="asks for 96"):
            program.build(run.cfg, run.program_trees, run.pack_arrays,
                          "cpu")
