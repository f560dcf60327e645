"""Phong vertex lighting (reference Sim3DR/lighting.py:23-71).

Counterpart of ``compute_vertex_light`` in
``synergynet_tpu/render/lighting.py``, with its quirks kept: vertices are
scaled into [-1, 1] by the GLOBAL max (``norm_vertices``, lighting.py:9-14);
the specular power is applied elementwise BEFORE the dot-sum
(lighting.py:59, not the standard (r.v)^n); the specular term is zeroed
where ``cos == 0`` and clipped twice.

The functions take leading batch dimensions on the vertices: each face is
normalised on its own, as the JAX package's vmap does.
"""

from __future__ import annotations

import torch

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
    kw = dict(dtype=torch.float32, device=vertices.device)
    light = torch.zeros(vertices.shape, **kw)
    ca = torch.tensor(color_ambient, **kw)
    cd = torch.tensor(color_directional, **kw)
    lp = torch.tensor(light_pos, **kw)
    vp = torch.tensor(view_pos, **kw)

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
