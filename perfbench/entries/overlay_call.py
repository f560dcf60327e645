"""Entry ``overlay_call``: ``FusedOverlayEngine.__call__`` on one BGR
uint8 numpy frame a call (``singleImage.py``'s overlay): the faces as
``frame_call`` has them, and the lit mesh overlay at the frame's size.

Traffic keys: those of ``frame_call`` and ``alpha``. The check adds the
overlay (``perfbench.reference.judge``, ``overlay_err``); the traced run
adds the raster's work on the ring's frames (``raster`` inputs).
"""

from __future__ import annotations

import torch

from perfbench import program
from perfbench.entries.frame_call import Entry as FrameEntry

UNIT = "frames"


class Entry(FrameEntry):
    def start(self):
        run = self.run
        self.engine = program.build(run.cfg, run.program_trees,
                                    run.pack_arrays, run.device)
        self.fn = program.overlay(self.engine, run.traffic["alpha"])
        self.intercept(self.engine)

    def judge_inputs(self, kept):
        canvas, hws, faces = super().judge_inputs(kept)
        faces["overlay"] = [torch.from_numpy(out[3]).to(self.run.device)
                            for _, out, _ in kept]
        faces["alpha"] = self.run.traffic["alpha"]
        return canvas, hws, faces

    @torch.inference_mode()
    def trace_inputs(self, inputs):
        """``raster``: the fragments and drawn pixels of the overlay's
        meshes (the served faces of every ring frame, as the reference's
        raster counts them) and the mesh sizes, per frame."""
        from perfbench.reference.pipeline import pack_tensors
        from perfbench.reference.precision import Precision, exact_f32
        from perfbench.reference.render import rasterize
        tri = pack_tensors(self.run.pack_arrays, self.run.device)["tri"]
        nver = self.run.pack_arrays["u_shp"].shape[0] // 3
        inputs["raster"] = []
        for k in range(len(self.ring)):
            self.call(k)
            out = self.inner
            n = int(out[1][0])
            dense = out[5][0, :n].transpose(1, 2).reshape(-1, 3)
            tris = torch.cat([tri + i * nver for i in range(n)])
            h, w = self.run.cfg["canvas"]
            with exact_f32():
                _, _, frags, drawn = rasterize(
                    Precision("f32"), dense, tris, torch.zeros_like(dense),
                    h, w)
            bucket = out[5].shape[1]
            inputs["raster"].append({"nver": bucket * nver,
                                     "ntri": bucket * tri.shape[0],
                                     "frags": frags, "drawn": drawn,
                                     "h": h, "w": w})
