"""One run of one cell: set-up, the measured window, the traced window,
the check, the result line.

Everything that belongs to one configuration, traffic mix, entry or
metric is a file found by its name:

- ``BENCHMARK.json`` (the repository root): the cells and which metrics
  each reports;
- ``perfbench/workloads/<cell>.json``: the cell's configuration, entry,
  traffic and the limits of its check;
- ``perfbench/configs/<config>.json``: the configuration as it is run,
  its regressor's architecture (``regressor.arch``) and crop size
  (``regressor.crop``) among it;
- ``perfbench/reference/regressors/<arch>.py``: the plain reference net
  of a regressor architecture and the leaves of its seeded tree;
- ``perfbench/counts/<arch>.py``: ``flops(s)``, the architecture's
  operations on an s x s crop;
- ``perfbench/entries/<entry>.py``: how a call is made and its outputs
  read (:class:`Entry`);
- ``perfbench/metrics/<metric>.py``: ``read(rec)`` -> the metric's value,
  or None where the run has nothing for it to read.

So a model configuration is added as new files and entries alone: its
configuration file, for an architecture the benchmark lacks its
``reference/regressors/<arch>.py`` and ``counts/<arch>.py``, a workload
file for each of its cells, and their entries under ``configs`` and
``workloads`` in ``BENCHMARK.json`` (with the cells added to the
``workloads`` of the metrics they report). Everything that crops, or
counts a crop, reads the configuration's ``regressor.crop``; the program
is given it too.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "synergynet_tpu")


class NoCard(RuntimeError):
    pass


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def folder(root: str) -> str:
    """The benchmark's folder in the checkout at ``root``."""
    return os.path.join(root, "perfbench")


def load_cell(root: str, name: str):
    """(benchmark, cell entry, workload file, config file) of cell
    ``name``. A workload file that ``BENCHMARK.json`` does not list yet
    runs as its own entry (its ``config`` and ``chips``): a cell kept
    ready, which the benchmark's metrics do not name."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    path = os.path.join(folder(root), "workloads", f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"no cell {name!r}: no {path}")
    traffic = read_json(path)
    cells = {w["name"]: w for w in bench["workloads"]}
    cell = cells.get(name) or {"name": name, "config": traffic["config"],
                               "chips": traffic["chips"]}
    cfg = read_json(os.path.join(folder(root), "configs",
                                 f"{cell['config']}.json"))
    return bench, cell, traffic, cfg


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: with ``trace`` its per-layer metrics,
    else its end-to-end ones; a metric without ``workloads`` is every
    cell's."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_module(root: str, kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` of the checkout at ``root``."""
    path = os.path.join(folder(root), kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path in the checkout."""
    base = os.path.join(root, "build", "perfbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(base, sub)


def card_info(torch) -> Dict:
    """The card's name, power limit and top SM clock (``nvidia-smi``)."""
    info = {"name": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0",
             "--query-gpu=power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.strip().split(",")
        info["power_limit_w"] = float(out[0])
        info["sm_clock_mhz"] = float(out[1])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return info


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def setup(root: str, name: str, seed: int, device: str,
          traffic_override: Optional[dict] = None):
    """The run's inputs from the seed, before any program exists ->
    (run, entry, reference trees, sampled call indices, benchmark, cell).
    ``device`` "cpu" serves the benchmark's own tests, which shrink the
    traffic with ``traffic_override``."""
    import torch

    from perfbench import bfm, weights

    bench, cell, traffic, cfg = load_cell(root, name)
    traffic.update(traffic_override or {})
    if device == "cuda":
        chips = cell["chips"]
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise NoCard(f"cell {name} needs {chips} CUDA device(s); "
                         f"torch sees {torch.cuda.device_count()}")
        torch.backends.cudnn.benchmark = False
    dev = torch.device(device)
    run = SimpleNamespace(root=root, cell=cell, traffic=traffic, cfg=cfg,
                          device=dev, seed=seed)
    ref_trees, run.program_trees = weights.configuration_weights(
        cfg, root, seed, dev)
    run.pack_arrays = bfm.load(root, cfg["pack"]["seed"])
    run.frames_gen = torch.Generator(device=dev).manual_seed(
        weights.stream(seed, 3))
    sample_gen = torch.Generator().manual_seed(weights.stream(seed, 4))
    entry = load_module(root, "entries", traffic["entry"]).Entry(run)
    sample = set(entry.sample(sample_gen))
    return run, entry, ref_trees, sample, bench, cell


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             traffic_override: Optional[dict] = None) -> Dict:
    """The run -> ``{"result": the last line's object, "check": the
    numbers and limits}`` (see :func:`setup` for ``device`` and
    ``traffic_override``; the CPU runs no trace and reads no device
    numbers)."""
    import torch

    from perfbench.reference.judge import judge
    from perfbench.reference.pipeline import pack_tensors

    run, entry, ref_trees, sample, bench, cell = setup(
        root, name, seed, device, traffic_override)
    cfg, traffic, dev = run.cfg, run.traffic, run.device
    cuda = device == "cuda"
    entry.start()
    entry.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    # -- the measured window --------------------------------------------------
    kept, lat = {}, []
    attempted = failed = 0
    units = 0
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        attempted += 1
        c0 = time.perf_counter()
        try:
            out = entry.call(k)
        except Exception:                       # a failed call counts
            traceback.print_exc()
            failed += 1
            k += 1
            continue
        lat.append(time.perf_counter() - c0)
        units = units + entry.count(out)
        if k in sample:
            kept[k] = entry.keep(out, k)
        k += 1
        del out
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    units = float(units)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded in the run: {found}")

    rec = SimpleNamespace(
        cfg=cfg, traffic=traffic, setup_s=setup_s, trace=None, spans={},
        inputs={}, card={},
        window={"calls": attempted - failed, "units": units,
                "seconds": window_s, "latencies_s": lat})
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1}
    if cuda and trace:
        from perfbench.tracing import traced_window
        rec.card = card_info(torch)
        rec.trace = traced_window(
            torch, entry.call, traffic["trace_calls"],
            os.path.join(root, "build", "perfbench", f"trace-{name}.json"))
        if hasattr(entry, "stages"):
            entry.stages(rec.spans)
        if hasattr(entry, "trace_inputs"):
            entry.trace_inputs(rec.inputs)
        device_info["busy_s"] = rec.trace["busy_s"]
        device_info["window_s"] = rec.trace["wall_s"]
    if cuda:
        device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            dev)
        device_info["power_limit_w"] = rec.card.get("power_limit_w") or \
            card_info(torch).get("power_limit_w")

    # -- the check, after the program's state is freed ------------------------
    entry.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = traffic["limits"]
    numbers: Dict[str, float] = {}
    t_check = time.perf_counter()
    if kept:
        canvas, hws, faces = entry.judge_inputs([kept[i] for i in
                                                 sorted(kept)])
        numbers = judge(cfg["regressor"], ref_trees["detector"],
                        ref_trees["regressor"],
                        pack_tensors(run.pack_arrays, dev), canvas, hws,
                        faces)
    check_s = time.perf_counter() - t_check
    check = {n: {"value": numbers.get(n), "limit": lim}
             for n, lim in limits.items()}
    correct = (bool(kept) and failed == 0
               and all(v["value"] is not None and v["value"] <= v["limit"]
                       for v in check.values()))

    metrics = {}
    for m in cell_metrics(bench, name, trace):
        if m["name"] == "setup_s":
            value: Optional[float] = setup_s
        else:
            value = load_module(root, "metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if rec.trace:
        from perfbench.tracing import top
        result["breakdown"] = {"device_ops": top(rec.trace["per_op_s"]),
                               "idle_gaps": top(rec.trace["idle_s"])}
    result["check_s"] = check_s
    result["check"] = check
    return {"result": result, "check": check}


def main(argv, t_start: float, root: str) -> int:
    ap = argparse.ArgumentParser(
        description="One run of one benchmark cell; prints one JSON line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env(root)
    try:
        out = run_cell(root, args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start)
    except NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    for n, v in out["check"].items():
        print(f"check {n} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0
