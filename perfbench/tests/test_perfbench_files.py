"""Configurations, cells and metric readers are files found by name; a
cell is added by adding files alone."""

import json
import os
import shutil

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
