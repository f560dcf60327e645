#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--out FILE]

For each of ``--seeds``, a whole run of the cell with a short window: the
program's numbers (the lower readings). For each of ``--control-seeds``,
the control in the program's place on the same sampled inputs: the
reference computed in fp8 (``perfbench.reference.precision``), the
nearest precision below the configuration's bf16, judged by the same
comparison (the upper readings). One JSON line per reading; all of them
to ``--out`` too.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(root: str, name: str, seed: int, device: str = "cuda",
                    traffic_override=None) -> dict:
    """The control's numbers for one seed."""
    import torch

    from perfbench import harness
    from perfbench.reference import pipeline as P
    from perfbench.reference.judge import judge
    from perfbench.reference.precision import Precision, exact_f32

    run, entry, ref, sample, _, _ = harness.setup(root, name, seed, device,
                                                  traffic_override)
    slots = [k % len(entry.ring) for k in sorted(sample)]
    canvas, hws = entry.canvases(slots)
    pack = P.pack_tensors(run.pack_arrays, run.device)
    regressor = run.cfg["regressor"]
    anc = P.anchors(canvas.shape[1], canvas.shape[2], run.device)
    faces = {}
    with exact_f32(), torch.no_grad():
        for f0 in range(0, canvas.shape[0], 16):
            part = P.serve(Precision("fp8"), regressor, ref["detector"],
                           ref["regressor"], pack, canvas[f0:f0 + 16],
                           hws[f0:f0 + 16], run.cfg["max_faces"], anc)
            for k, v in part.items():
                faces.setdefault(k, []).append(v)
    faces = {k: torch.cat(v) for k, v in faces.items()}
    if "alpha" in run.traffic:             # the overlay, rendered in fp8
        from perfbench.reference.render import as_served, overlay
        faces["alpha"] = run.traffic["alpha"]
        with exact_f32(), torch.no_grad():
            faces["overlay"] = [as_served(overlay(
                Precision("fp8"), canvas[i],
                faces["dense"][i, :int(faces["n"][i])], pack["tri"],
                faces["alpha"])[0], hws[i].tolist(), entry.ring[s].shape[:2])
                for i, s in enumerate(slots)]
    return judge(regressor, ref["detector"], ref["regressor"], pack, canvas,
                 hws, faces)


def main() -> int:
    sys.path[0] = ROOT
    from perfbench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    harness.cache_env(ROOT)
    lines = []

    def emit(d):
        lines.append(d)
        print(json.dumps(d), flush=True)

    for s in filter(None, args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(ROOT, args.workload, int(s), args.seconds,
                               False, t0)
        r = out["result"]
        emit({"kind": "program", "seed": int(s), "correct": r["correct"],
              "numbers": {k: v["value"] for k, v in out["check"].items()},
              "setup_s": r["metrics"].get("setup_s", {}).get("value"),
              "metrics": r["metrics"]})
    for s in filter(None, args.control_seeds.split(",")):
        emit({"kind": "control", "seed": int(s),
              "numbers": control_numbers(ROOT, args.workload, int(s))})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(d) for d in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
