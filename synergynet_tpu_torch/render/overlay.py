"""Mesh overlay, the reference's application wrapper (utils/render.py:
31-50).

Counterpart of ``synergynet_tpu/render/overlay.py``: every face's dense
mesh is rendered lit and solid by its own :class:`RenderPipeline` call over
the previous result, so a later face overdraws an earlier one where they
overlap (the reference's order), and the solid layer is then blended once
onto the image with ``cv2.addWeighted``'s rounding. The serving overlay
(:class:`~synergynet_tpu_torch.pipeline.FusedOverlayEngine`) instead
resolves all faces in one z-buffer; the two agree where faces do not
overlap.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from synergynet_tpu_torch.render.lighting import (OVERLAY_LIGHT_CFG,
                                                  RenderPipeline)
from synergynet_tpu_torch.render.raster import as_tensor


def add_weighted_u8(a: np.ndarray, wa: float, b: np.ndarray, wb: float
                    ) -> np.ndarray:
    """cv2.addWeighted(a, wa, b, wb, 0) equivalent: round-half-away, uint8."""
    out = np.floor(a.astype(np.float64) * wa + b.astype(np.float64) * wb + 0.5)
    return np.clip(out, 0, 255).astype(np.uint8)


def render_overlay(img_bgr: np.ndarray,
                   vertices_lst: Sequence[np.ndarray],
                   tri: Optional[np.ndarray],
                   alpha: float = 0.6,
                   connectivity: Optional[np.ndarray] = None,
                   pipeline: Optional[RenderPipeline] = None,
                   texture: Optional[np.ndarray] = None,
                   with_solid: bool = True):
    """Render every face mesh onto ``img_bgr`` on the pipeline's device
    (a default pipeline, with the overlay light, runs on the card).

    ``vertices_lst``: per-face (3, N) vertices in image coordinates (the
    decode output layout); ``tri``: (3, T) 0-based triangles
    (``connectivity`` overrides it, reference utils/render.py:35-36);
    ``texture``: optional (N, 3) per-vertex colors in [0, 1], modulated by
    the lighting like the reference's ``tex`` argument. Returns
    (overlay, solid) -- ``overlay`` is the alpha-composited result, ``solid``
    the fully-opaque render layer (the reference writes it as
    ``_solid.png``); ``solid`` is None unless ``with_solid``. The frame and
    the topology go to the device once; the solid layer stays there
    between faces.
    """
    pipeline = pipeline or RenderPipeline(**OVERLAY_LIGHT_CFG)
    dev = pipeline.device
    tris = np.ascontiguousarray(
        (connectivity if connectivity is not None else tri).T
    ).astype(np.int32)
    solid = as_tensor(img_bgr, torch.uint8, dev)
    if len(vertices_lst):
        tris_t = as_tensor(tris, torch.int32, dev)
        rings = pipeline.rings(tris, int(np.shape(vertices_lst[0])[1]))
        tex = None if texture is None else as_tensor(texture, torch.float32,
                                                     dev)
        for ver in vertices_lst:
            verts = as_tensor(np.asarray(ver).T, torch.float32, dev)
            solid = pipeline.render(verts, tris_t, solid, rings, tex)
    solid = solid.cpu().numpy()
    res = add_weighted_u8(img_bgr, 1 - alpha, solid, alpha)
    return (res, solid) if with_solid else (res, None)
