"""Entry ``frame_call``: ``FusedFrameEngine.__call__`` on one BGR uint8
numpy frame a call, numpy outputs back: a live camera's loop.

``__call__`` returns no rois; the check follows the served roi (see
``perfbench.reference.judge``). So the entry holds the batch outputs of
the engine's public ``process_batch`` that ``__call__`` calls, one
frame's tensors at a time, and the check reads the rois and parameters of
the sampled frames from them, beside ``__call__``'s own outputs.

Traffic keys: ``frame_hw``, ``ring`` (seeded host frames made at set-up,
cycled), ``check_calls`` (calls whose outputs are judged, drawn from the
seed among the first ``check_within``), ``trace_calls``. A call's work
is one frame.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import program
from perfbench.reference.pipeline import fit_frame, fit_scale

UNIT = "frames"


class Entry:
    def __init__(self, run):
        self.run = run
        t = run.traffic
        h, w = t["frame_hw"]
        self.engine = self.fn = self.inner = None
        u8 = torch.randint(0, 256, (t["ring"], h, w, 3),
                           generator=run.frames_gen, device=run.device,
                           dtype=torch.uint8)
        self.ring = list(u8.cpu().numpy())

    def start(self):
        """Build the program."""
        run = self.run
        self.engine = self.fn = program.build(
            run.cfg, run.program_trees, run.pack_arrays, run.device)
        self.intercept(self.engine)

    def intercept(self, engine):
        """Hold ``engine.process_batch``'s last outputs in ``inner``."""
        batch = engine.process_batch

        def process_batch(*args):
            self.inner = batch(*args)
            return self.inner

        engine.process_batch = process_batch

    def sample(self, gen):
        t = self.run.traffic
        return sorted(torch.randperm(t["check_within"], generator=gen)
                      [:t["check_calls"]].tolist())

    def warm(self):
        """Every ring frame once: each face count the ring's frames give
        has its captured programs before the window."""
        for k in range(len(self.ring)):
            self.call(k)

    def call(self, k):
        return self.fn(self.ring[k % len(self.ring)])

    @staticmethod
    def count(out):
        return 1

    def keep(self, out, k):
        return k % len(self.ring), out, self.inner

    def canvases(self, slots):
        """The reference's inputs for ring ``slots``: (canvases fitted by
        the reference, true extents)."""
        fits = [fit_frame(self.ring[s], self.run.device) for s in slots]
        return (torch.stack([c for c, _, _ in fits]),
                torch.tensor([hw for _, hw, _ in fits], dtype=torch.int32,
                             device=self.run.device))

    def judge_inputs(self, kept):
        dev = self.run.device
        f = self.run.cfg["max_faces"]
        canvas, hws = self.canvases([slot for slot, _, _ in kept])
        faces = {k: [] for k in ("n", "lmk", "dense", "angles", "t3d",
                                 "rois", "param")}
        for slot, out, inner in kept:
            scale = fit_scale(*self.ring[slot].shape[:2])
            pts, verts, poses = out[:3]
            n = len(pts)
            nver = self.run.pack_arrays["u_shp"].shape[0] // 3

            def stack(xs, shape):
                a = np.zeros((f,) + shape, np.float32)
                if n:
                    a[:n] = np.stack(xs)
                return torch.tensor(a, device=dev)

            faces["n"].append(n)
            faces["lmk"].append(stack(pts, (3, 68)) * scale)
            faces["dense"].append(stack(verts, (3, nver)) * scale)
            faces["angles"].append(stack([q[0] for q in poses], (3,)))
            t3d = stack([q[1] for q in poses], (3,))
            t3d[:, :2] *= scale
            faces["t3d"].append(t3d)
            faces["rois"].append(inner[2][0])
            faces["param"].append(inner[3][0])
        out = {k: torch.stack(v) for k, v in faces.items() if k != "n"}
        out["n"] = torch.tensor(faces["n"], device=dev)
        return canvas, hws, out

    def stages(self, spans, repeats=2):
        """``prep``: ``prepare_frame`` on every ring frame, host clock,
        ended by a synchronize."""
        for _ in range(repeats):
            for img in self.ring:
                t0 = time.perf_counter()
                program.prepare_frame(self.engine, img)
                torch.cuda.synchronize()
                spans.setdefault("prep", []).append(time.perf_counter() - t0)

    def release(self):
        self.engine = self.fn = None
