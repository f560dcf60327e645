"""Overlay serving: frame -> detected faces -> lit mesh overlay.

Counterpart of ``synergynet_tpu/pipeline/overlay_engine.py``, the
reference's full ``singleImage.py`` experience (singleImage.py:54-118:
detect -> crop -> regress -> dense mesh -> lit render -> alpha overlay).
The detect/regress/decode stages are :class:`FusedFrameEngine`'s. The
render stage lights each face on its own (one-ring normals, Phong, as the
reference normalises per face), concatenates all faces' meshes into one,
parks padding faces far off the canvas so that their triangles clamp to
empty bboxes, rasterizes once with ``csrc/raster_tiled.cu`` and blends
into the frame. As in the JAX package, one z-buffer resolves occlusion
between faces, where the reference's later faces simply overdraw earlier
ones; the two agree whenever faces do not overlap.

The JAX package compiles this into one program and picks the face bucket
with ``lax.switch``. On a card the port replays two captured programs
(:mod:`synergynet_tpu_torch.pipeline.program`): the engine's one-frame
program, then, after one host read of the face count, the render program of
the power-of-two face bucket that holds it, captured per bucket. On the CPU
it runs eagerly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from synergynet_tpu_torch.core.profiling import annotate
from synergynet_tpu_torch.detect.detector import prepare_frame
from synergynet_tpu_torch.ops.resize import _resize_linear
from synergynet_tpu_torch.pipeline.api import unpack_face_outputs
from synergynet_tpu_torch.pipeline.program import ProgramCache
from synergynet_tpu_torch.render.lighting import (OVERLAY_LIGHT_CFG,
                                                  compute_vertex_light)
from synergynet_tpu_torch.render.normals import (get_normal_rings,
                                                 one_ring_table)
from synergynet_tpu_torch.render.raster import blend_uint8
from synergynet_tpu_torch.render.raster_tiled import rasterize_buffers_tiled

PARK = 1e7      # offset that moves a padding face off any canvas


def light_faces(verts: torch.Tensor, valid: torch.Tensor,
                tris_face: torch.Tensor, rings: torch.Tensor,
                light_cfg: Optional[dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F, N, 3) per-face image-space vertices + (F,) bool ``valid`` ->
    (vertices with invalid faces parked at +PARK, per-vertex light
    (F, N, 3)), each face normalised and lit on its own."""
    cfg = dict(OVERLAY_LIGHT_CFG if light_cfg is None else light_cfg)
    verts = torch.where(valid[:, None, None], verts, verts + PARK)
    normals = get_normal_rings(verts, tris_face, rings)
    return verts, compute_vertex_light(verts, normals, **cfg)


def composite(frame_u8: torch.Tensor, zbuf: torch.Tensor,
              color: torch.Tensor, alpha: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solid render, then the alpha composite of reference
    utils/render.py:40-44 (``addWeighted(img, 1-alpha, solid, alpha)``) in
    f32 with round-half-up -> (overlay, solid) uint8."""
    solid = blend_uint8(frame_u8, zbuf, color, 1.0)
    overlay = torch.clip(torch.floor(
        (1.0 - alpha) * frame_u8.float() + alpha * solid.float() + 0.5),
        0, 255).to(torch.uint8)
    return overlay, solid


def render_lit_faces(frame_u8: torch.Tensor, verts: torch.Tensor,
                     valid: torch.Tensor, tris_face: torch.Tensor,
                     tris_all: torch.Tensor, rings: torch.Tensor, *,
                     alpha: float = 0.6, light_cfg: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W, 3) uint8 frame + (F, N, 3) per-face image-space vertices ->
    (overlay, solid) uint8 images.

    ``valid`` (F,) bool masks real faces; ``tris_face`` (T, 3) the
    single-face topology; ``tris_all`` (F*T, 3) the concatenated topology;
    ``rings`` the single-face one-ring table; all on the frame's device.
    """
    h, w = frame_u8.shape[:2]
    verts, light = light_faces(verts, valid, tris_face, rings, light_cfg)
    # The light keeps the meshes' (F, 3, N) layout, so at one face the
    # flat (N, 3) views are strided: the kernel takes contiguous rows.
    zbuf, color = rasterize_buffers_tiled(
        verts.reshape(-1, 3).contiguous(), tris_all,
        light.reshape(-1, 3).contiguous(), h=h, w=w)
    return composite(frame_u8, zbuf, color, alpha)


def _face_buckets(f: int):
    out, b = [], 1
    while b < f:
        out.append(b)
        b *= 2
    out.append(f)
    return out


def render_lit_faces_adaptive(frame_u8: torch.Tensor, verts: torch.Tensor,
                              n_valid: int, tris_face: torch.Tensor,
                              tris_all: torch.Tensor, rings: torch.Tensor, *,
                              alpha: float = 0.6,
                              light_cfg: Optional[dict] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`render_lit_faces` over the smallest power-of-two bucket of
    faces that holds the first ``n_valid`` (valid faces come first in
    ``verts``), so the render scales with the detected face count; no face
    returns the frame unchanged."""
    n = min(int(n_valid), verts.shape[0])
    if n <= 0:
        return frame_u8, frame_u8
    return render_lit_faces_bucket(frame_u8, verts, n,
                                   face_bucket(n, verts.shape[0]), tris_face,
                                   tris_all, rings, alpha=alpha,
                                   light_cfg=light_cfg)


def face_bucket(n: int, f: int) -> int:
    """The smallest power-of-two bucket of ``f`` faces (or ``f``) that
    holds ``n`` >= 1 faces."""
    return next(b for b in _face_buckets(f) if b >= n)


def render_lit_faces_bucket(frame_u8: torch.Tensor, verts: torch.Tensor,
                            n_valid, bucket: int, tris_face: torch.Tensor,
                            tris_all: torch.Tensor, rings: torch.Tensor, *,
                            alpha: float = 0.6,
                            light_cfg: Optional[dict] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`render_lit_faces` over the first ``bucket`` faces of
    ``verts``, the first ``n_valid`` of them real: an int, or a 0-dim
    tensor on the device, so the render reads nothing from the host."""
    t = tris_face.shape[0]
    valid = torch.arange(bucket, device=verts.device) < n_valid
    return render_lit_faces(frame_u8, verts[:bucket], valid, tris_face,
                            tris_all[:bucket * t], rings, alpha=alpha,
                            light_cfg=light_cfg)


class FusedOverlayEngine:
    """Wrap a :class:`FusedFrameEngine`; calls return the reference-format
    outputs plus the rendered overlay, all computed on the engine's
    device. On a card the render replays one captured program per face
    bucket (``programs``)."""

    def __init__(self, engine, alpha: float = 0.6,
                 light_cfg: Optional[dict] = None):
        self.engine = engine
        self.alpha = float(alpha)
        self.light_cfg = dict(OVERLAY_LIGHT_CFG if light_cfg is None
                              else light_cfg)
        pack = engine.api.pack
        # int32 topology: half the bytes of int64 for the raster kernel and
        # the normals' gathers to read.
        tris = np.ascontiguousarray(pack.tri.cpu().numpy().T).astype(np.int32)
        nver = pack.nver
        f = engine.max_faces
        dev = engine.api.device
        self.tris_face = torch.from_numpy(tris).to(dev)
        self.tris_all = torch.from_numpy(
            (tris[None] + (np.arange(f, dtype=np.int32) * nver)[:, None, None]
             ).reshape(-1, 3)).to(dev)
        self.rings = one_ring_table(tris, nver).long().to(dev)
        self.programs = ProgramCache(dev, "overlay",
                                     kernels=("raster_tiled",))

    def render(self, frame_u8: torch.Tensor, dense: torch.Tensor,
               n_faces: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(CH, CW, 3) uint8 canvas + (F, 3, N) canvas-space dense meshes,
        the first ``n_faces`` real -> (overlay, solid) on the canvas."""
        return render_lit_faces_adaptive(
            frame_u8, dense.transpose(1, 2), n_faces, self.tris_face,
            self.tris_all, self.rings, alpha=self.alpha,
            light_cfg=self.light_cfg)

    def render_bucket(self, canvas: torch.Tensor, dense: torch.Tensor,
                      n_faces: torch.Tensor, bucket: int) -> torch.Tensor:
        """The render of the first ``bucket`` faces, with no host read:
        (CH, CW, 3) f32 canvas + (F, 3, N) canvas-space dense meshes + the
        0-dim face count on the device (1 <= count <= bucket) -> the
        (CH, CW, 3) uint8 overlay; what a card's render program captures.
        Equal bit for bit to :meth:`render` at the same count."""
        overlay, _ = render_lit_faces_bucket(
            canvas.clamp(0, 255).to(torch.uint8), dense.transpose(1, 2),
            n_faces, bucket, self.tris_face, self.tris_all, self.rings,
            alpha=self.alpha, light_cfg=self.light_cfg)
        return overlay

    @torch.inference_mode()
    def __call__(self, img_bgr: np.ndarray):
        """One BGR uint8 frame -> (pts_res, vertices_lst, poses,
        overlay_bgr): the first three exactly as ``FusedFrameEngine``'s, the
        overlay uint8 at the input's resolution. Oversized inputs render on
        the <=720x1088 canvas and scale back with ``_resize_linear``,
        which equals the JAX package's ``cv2.resize`` bit for bit. On a
        card: the engine's one-frame program, one read of the face count,
        then the render program of its bucket (none at zero faces).
        Under a profiler: the spans ``synergy.overlay`` >
        ``synergy.prep``, the engine's
        ``synergy.process_batch``, ``synergy.read_count`` (the face count's
        read: the host waits for the frame's program), ``synergy.render``
        (the render program, the crop and any rescale, enqueued),
        ``synergy.to_host`` (the outputs' and the overlay's copies) and
        ``synergy.unpack``."""
        eng = self.engine
        h, w = img_bgr.shape[:2]
        with annotate("synergy.overlay"):
            with annotate("synergy.prep"):
                canvas, packed, true_hw, scale = prepare_frame(
                    img_bgr, eng.detector.stem_r, eng.api.device)
            out = eng.process_batch(canvas[None], packed[None],
                                    true_hw[None])
            _, n_t, _, _, lmk, dense, angles, t3d = (x[0] for x in out)
            with annotate("synergy.read_count"):
                n = int(n_t)
            with annotate("synergy.render"):
                if n <= 0:
                    overlay = canvas.clamp(0, 255).to(torch.uint8)
                elif canvas.device.type == "cuda":
                    fb = face_bucket(n, dense.shape[0])
                    overlay, = self.programs.run(
                        f"render.f{fb}", lambda c, d, k: (self.render_bucket(
                            c, d, k, fb),), canvas, dense, n_t)
                else:
                    overlay = self.render_bucket(
                        canvas, dense, n_t, face_bucket(n, dense.shape[0]))
                hs, ws = true_hw.tolist()
                ov = overlay[:hs, :ws]
                if scale != 1.0:
                    ov = _resize_linear(ov, h, w).to(torch.uint8)
            with annotate("synergy.to_host"):
                host = [x.cpu().numpy() for x in (lmk, dense, angles, t3d)]
                ov = ov.cpu().numpy()
            with annotate("synergy.unpack"):
                pts, verts, poses = unpack_face_outputs(n, *host, scale)
        return pts, verts, poses, ov
