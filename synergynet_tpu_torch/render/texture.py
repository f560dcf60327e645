"""Per-pixel UV texture-mapped rendering.

Counterpart of ``synergynet_tpu/render/texture.py`` (the reference's
``_render_texture_core``, Sim3DR/lib/rasterize_kernel.cpp, declared
rasterize.h:103-108): for every pixel, find the visible triangle,
interpolate its corners' UV coordinates, and sample the texture image
(nearest or bilinear). As in the JAX package's tiled path
(``rasterize_texture_buffers_tiled``, ``texture.py:81-99``), the UV
coordinates ride through the z-buffer kernel (B2) as two per-vertex
payloads, and the winning pixel's UVs drive one texture sample.

The JAX package's window path crops triangles larger than its 32 px
window, and its TPU path falls back to a native host renderer past its
replication budget; the Hopper kernel takes every triangle whole, so
neither is ported (``window`` must be ``None``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.render.raster import (as_tensor, blend_uint8,
                                                no_window)
from synergynet_tpu_torch.render.raster_tiled import rasterize_mesh


# uint8 -> [0, 1] by true division, computed once on the CPU: a CUDA
# tensor divided by a Python scalar is multiplied by its reciprocal, which
# differs in the last bit.
_UNIT_U8 = torch.arange(256, dtype=torch.float32) / 255.0


def _sample_texture(ubuf: torch.Tensor, vbuf: torch.Tensor,
                    texture: torch.Tensor, bilinear: bool) -> torch.Tensor:
    """Per-pixel texture lookup from interpolated UVs (..., ) -> (..., 3)
    f32 in [0, 1]. ``texture``: (TH, TW, 3) float in [0, 1] or uint8 (read
    as value / 255). v is measured from the bottom (the BFM_UV convention;
    the reference flips the texture vertically before lookup,
    artistic.py:111-113)."""
    if texture.dtype == torch.uint8:
        tex = _UNIT_U8.to(texture.device)[texture.long()]
    else:
        tex = texture.float()
    th, tw = tex.shape[:2]
    tx = ubuf * (tw - 1)
    ty = (1.0 - vbuf) * (th - 1)
    if bilinear:
        x0 = torch.clip(torch.floor(tx), 0, tw - 1)
        y0 = torch.clip(torch.floor(ty), 0, th - 1)
        x1 = torch.clip(x0 + 1, 0, tw - 1)
        y1 = torch.clip(y0 + 1, 0, th - 1)
        fx = (tx - x0)[..., None]
        fy = (ty - y0)[..., None]

        def g(yy, xx):
            return tex[yy.long(), xx.long()]
        return ((g(y0, x0) * (1 - fx) + g(y0, x1) * fx) * (1 - fy)
                + (g(y1, x0) * (1 - fx) + g(y1, x1) * fx) * fy)
    return tex[torch.clip(torch.round(ty), 0, th - 1).long(),
               torch.clip(torch.round(tx), 0, tw - 1).long()]


def rasterize_texture_buffers(vertices, triangles, tex_coords, texture, *,
                              h: int, w: int, win_h: Optional[int] = None,
                              win_w: Optional[int] = None,
                              bilinear: bool = True, device="cuda"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(zbuf (h, w) f32 init -1e8, color (h, w, 3) in [0, 1]) of a
    UV-mapped mesh, tensors on ``device`` (the card unless the caller asks
    for the CPU). ``tex_coords``: (V, 2) per-vertex (u, v) in [0, 1] (v
    up, like BFM_UV); ``texture``: (TH, TW, 3) float in [0, 1] or uint8.
    The UVs are kernel B2's two payloads."""
    no_window((win_h, win_w))
    dev = resolve_device(device)
    zbuf, uv = rasterize_mesh(as_tensor(vertices, torch.float32, dev),
                              as_tensor(triangles, torch.int32, dev),
                              as_tensor(tex_coords, torch.float32, dev),
                              h=h, w=w)
    tex = texture.to(dev) if torch.is_tensor(texture) else \
        torch.from_numpy(np.ascontiguousarray(texture)).to(dev)
    # The kernel's payloads are 0 where undrawn, as the JAX package masks
    # them.
    return zbuf, _sample_texture(uv[..., 0], uv[..., 1], tex, bilinear)


def render_texture(vertices, triangles, tex_coords, texture, bg,
                   alpha: float = 1.0, reverse: bool = False,
                   window: Optional[Tuple[int, int]] = None,
                   bilinear: bool = True, device="cuda") -> np.ndarray:
    """UV texture-mapped render over a uint8 background on ``device`` (the
    card unless the caller asks for the CPU) -> uint8 image (numpy).

    vertices (V, 3) image-space, triangles (T, 3) int, tex_coords (V, 2) in
    [0, 1], texture (TH, TW, 3); ``window`` must be ``None``."""
    no_window(window)
    dev = resolve_device(device)
    bg = np.asarray(bg, np.uint8)
    h, w = bg.shape[:2]
    zbuf, color = rasterize_texture_buffers(
        vertices, triangles, tex_coords, texture, h=h, w=w,
        bilinear=bilinear, device=dev)
    return blend_uint8(torch.from_numpy(bg).to(dev), zbuf, color,
                       float(alpha), reverse=reverse).cpu().numpy()
