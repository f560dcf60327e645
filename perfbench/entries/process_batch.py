"""Entry ``process_batch``: ``FusedFrameEngine.process_batch`` on a batch
of canvases that sit on the card, outputs left on the card.

Traffic keys: ``frames_per_call``, ``frame_hw`` (the canvas), ``ring``
(seeded batches made at set-up, cycled), ``check_calls`` (calls whose
outputs are judged, drawn from the seed among the first ``check_rounds``
rounds of the ring), ``trace_calls``. A call's work is its faces
(``n_faces`` summed).
"""

from __future__ import annotations

import torch

from perfbench import program

UNIT = "faces"


class Entry:
    def __init__(self, run):
        self.run = run
        t = run.traffic
        b = t["frames_per_call"]
        h, w = t["frame_hw"]
        self.engine = None
        self.ring = []
        for _ in range(t["ring"]):
            u8 = torch.randint(0, 256, (b, h, w, 3), generator=run.frames_gen,
                               device=run.device, dtype=torch.uint8)
            hws = torch.tensor([[h, w]] * b, dtype=torch.int32,
                               device=run.device)
            self.ring.append((u8.float(), hws))

    def start(self):
        """Build the program and pack its inputs."""
        run = self.run
        self.engine = program.build(run.cfg, run.program_trees,
                                    run.pack_arrays, run.device)
        r = self.engine.detector.stem_r
        self.ring = [(f, program.space_to_depth(f, r), hws)
                     for f, hws in self.ring]

    def sample(self, gen):
        """Call indices whose outputs are judged: one per ring slot in
        each of ``check_calls`` draws."""
        n, t = len(self.ring), self.run.traffic
        rounds = torch.randint(0, t["check_rounds"], (t["check_calls"],),
                               generator=gen).tolist()
        return sorted({r * n + i % n for i, r in enumerate(rounds)})

    def warm(self):
        for k in range(2 * len(self.ring)):
            self.call(k)

    def call(self, k):
        return self.engine.process_batch(*self.ring[k % len(self.ring)])

    @staticmethod
    def count(out):
        return out[1].sum()

    def keep(self, out, k):
        return k % len(self.ring), out

    def canvases(self, slots):
        """The reference's inputs for ring ``slots``: (canvases, true
        extents)."""
        return (torch.cat([self.ring[s][0] for s in slots]),
                torch.cat([self.ring[s][-1] for s in slots]))

    def judge_inputs(self, kept):
        canvas, hws = self.canvases([slot for slot, _ in kept])
        cat = [torch.cat([out[i] for _, out in kept]) for i in range(8)]
        return canvas, hws, {
            "n": cat[1], "rois": cat[2], "param": cat[3], "lmk": cat[4],
            "dense": cat[5], "angles": cat[6], "t3d": cat[7]}

    @torch.inference_mode()
    def trace_inputs(self, inputs):
        """``nms``: the work (``perfbench.counts.nms``) of each ring
        batch's own candidates: the program's eager ``detect_candidates``,
        its 2,048 best, kept by the reference's greedy NMS."""
        from perfbench.counts import nms
        from perfbench.reference.pipeline import greedy_keep, top_candidates
        inputs["nms"] = []
        for frames, s2d, hws in self.ring:
            scores, boxes = self.engine.detect_candidates(s2d, hws)
            _, top, valid = top_candidates(
                {"score": scores, "boxes": boxes, "valid": scores > 0})
            inputs["nms"].append(nms.work(torch, valid,
                                          greedy_keep(top, valid)))

    def release(self):
        self.engine = None
