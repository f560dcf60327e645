"""Phong vertex lighting and the lit mesh renderer (reference
Sim3DR/lighting.py:23-71).

Counterpart of ``compute_vertex_light`` and ``RenderPipeline`` in
``synergynet_tpu/render/lighting.py``, with the lighting's quirks kept:
vertices are scaled into [-1, 1] by the GLOBAL max (``norm_vertices``,
lighting.py:9-14); the specular power is applied elementwise BEFORE the
dot-sum (lighting.py:59, not the standard (r.v)^n); the specular term is
zeroed where ``cos == 0`` and clipped twice.

The light functions take leading batch dimensions on the vertices: each
face is normalised on its own, as the JAX package's vmap does.
:class:`RenderPipeline` renders one mesh per call on its device: one-ring
normals (the deterministic gather, as the JAX package's tiled path),
the light, kernel B2 with the lit (or textured) colors as payloads, and
the blend at alpha 1. The JAX package's ``tiled`` and ``window`` choose
between its TPU rasterizers and are not taken; it falls back to a native
host z-buffer when its replication budget is exceeded, which the Hopper
kernel, taking any triangle whole, does not need.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from synergynet_tpu_torch.core.device import device_constant, resolve_device
from synergynet_tpu_torch.render.normals import (get_normal_rings,
                                                 one_ring_table)
from synergynet_tpu_torch.render.raster import (as_tensor, blend_uint8,
                                                no_window)
from synergynet_tpu_torch.render.raster_tiled import rasterize_mesh

# Default lighting config of the overlay app (reference utils/render.py:18-27).
OVERLAY_LIGHT_CFG = dict(
    intensity_ambient=0.75, color_ambient=(1, 1, 1),
    intensity_directional=0.7, color_directional=(1, 1, 1),
    intensity_specular=0.2, specular_exp=5,
    light_pos=(0, 0, 5), view_pos=(0, 0, 5),
)


def _int_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for a Python int n >= 1 by square-and-multiply, in the order
    of ``lax.integer_pow``, so that ``x ** 5`` rounds as in the JAX
    package."""
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"specular_exp must be a Python int >= 1, not {n!r}")
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def _norm_rows(a: torch.Tensor) -> torch.Tensor:
    return a / torch.sqrt((a * a).sum(dim=-1, keepdim=True))


def norm_vertices_unit(vertices: torch.Tensor) -> torch.Tensor:
    """Scale vertices (..., V, 3) into ~[-1, 1] (reference
    lighting.py:9-14)."""
    v = vertices - vertices.amin(dim=-2, keepdim=True)
    v = v / v.amax(dim=(-2, -1), keepdim=True)
    v = v * 2
    return v - v.amax(dim=-2, keepdim=True) / 2


def compute_vertex_light(vertices: torch.Tensor, normal: torch.Tensor, *,
                         intensity_ambient=0.3, intensity_directional=0.6,
                         intensity_specular=0.1, specular_exp=5,
                         color_ambient=(1, 1, 1), color_directional=(1, 1, 1),
                         light_pos=(0, 0, 5), view_pos=(0, 0, 5)
                         ) -> torch.Tensor:
    """Per-vertex RGB light (..., V, 3) in [0, 1] (reference
    lighting.py:37-63)."""
    dev = vertices.device
    light = torch.zeros(vertices.shape, dtype=torch.float32, device=dev)
    ca, cd, lp, vp = (device_constant(tuple(v), torch.float32, dev)
                      for v in (color_ambient, color_directional, light_pos,
                                view_pos))

    if intensity_ambient > 0:
        light = light + intensity_ambient * ca

    if intensity_directional > 0:
        vn = norm_vertices_unit(vertices)
        direction = _norm_rows(lp - vn)
        cos = (normal * direction).sum(dim=-1, keepdim=True)
        light = light + intensity_directional * (cd * torch.clip(cos, 0, 1))
        if intensity_specular > 0:
            v2v = _norm_rows(vp - vn)
            reflection = 2 * cos * normal - direction
            spe = _int_pow(v2v * reflection, specular_exp).sum(
                dim=-1, keepdim=True)
            spe = torch.where(cos != 0, torch.clip(spe, 0, 1),
                              torch.zeros_like(spe))
            light = light + intensity_specular * cd * torch.clip(spe, 0, 1)
    return torch.clip(light, 0, 1)


class RenderPipeline:
    """Lit solid or per-vertex-colored mesh renderer (reference
    Sim3DR/lighting.py:23-71) on ``device`` (the card unless the caller
    asks for the CPU). Construct once; ``__call__(vertices, triangles, bg,
    texture=None)`` returns a uint8 image with the mesh composited over
    ``bg``. ``cfg`` overrides the light of :func:`compute_vertex_light`."""

    def __init__(self, device="cuda", **cfg):
        self.device = resolve_device(device)
        self.cfg = {**dict(intensity_ambient=0.3, intensity_directional=0.6,
                           intensity_specular=0.1, specular_exp=5,
                           color_ambient=(1, 1, 1), color_directional=(1, 1, 1),
                           light_pos=(0, 0, 5), view_pos=(0, 0, 5)), **cfg}
        self._rings: dict = {}

    def update_light_pos(self, light_pos):
        self.cfg["light_pos"] = tuple(np.asarray(light_pos, np.float64))

    def rings(self, triangles: np.ndarray, nver: int) -> torch.Tensor:
        """The topology's one-ring table as int64 on the device, cached by
        topology content."""
        table = one_ring_table(triangles, nver)
        # one_ring_table keeps every table it builds, so ids stay unique.
        if id(table) not in self._rings:
            self._rings[id(table)] = table.long().to(self.device)
        return self._rings[id(table)]

    def render(self, vertices: torch.Tensor, triangles: torch.Tensor,
               bg: torch.Tensor, rings: torch.Tensor,
               texture: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The render on device tensors: (V, 3) f32 vertices, (T, 3) int32
        triangles, (H, W, C) uint8 background, the topology's ``rings``,
        optional (V, 3) per-vertex colors in [0, 1] -> (H, W, C) uint8."""
        h, w = bg.shape[:2]
        normal = get_normal_rings(vertices, triangles, rings)
        light = compute_vertex_light(vertices, normal, **self.cfg)
        colors = light if texture is None else texture * light
        zbuf, color = rasterize_mesh(vertices, triangles, colors, h=h, w=w)
        return blend_uint8(bg, zbuf, color, 1.0)

    def __call__(self, vertices, triangles, bg,
                 texture: Optional[np.ndarray] = None, window=None,
                 tiled: Optional[bool] = None) -> np.ndarray:
        """vertices (V, 3) image-space, triangles (T, 3) int, bg (H, W, C)
        uint8, optional texture (V, 3) per-vertex colors in [0, 1] -> uint8
        image (numpy). ``window`` and ``tiled`` must be ``None``."""
        no_window(window)
        if tiled is not None:
            raise ValueError(f"tiled={tiled!r}: the port has one rasterizer;"
                             " pass None")
        dev = self.device
        tris = np.asarray(triangles)
        out = self.render(
            as_tensor(vertices, torch.float32, dev),
            as_tensor(tris, torch.int32, dev),
            as_tensor(bg, torch.uint8, dev),
            self.rings(tris, int(np.shape(vertices)[0])),
            None if texture is None else as_tensor(texture, torch.float32,
                                                   dev))
        return out.cpu().numpy()
