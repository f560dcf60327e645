"""Z-buffer constants and the uint8 blend.

Counterpart of ``synergynet_tpu/render/raster.py``: the depth the z-buffer
starts from and the reference's truncating blend. The fragment-window
rasterizer of that module is not ported here; the overlay path rasterizes
with :mod:`synergynet_tpu_torch.render.raster_tiled`.
"""

from __future__ import annotations

import torch

DEPTH_INIT = -1e8    # reference Sim3DR/Sim3DR.py:25


def blend_uint8(bg_u8: torch.Tensor, zbuf: torch.Tensor, color: torch.Tensor,
                alpha: float, reverse: bool = False) -> torch.Tensor:
    """uint8 truncation blend of resolved color into the background
    (reference rasterize_kernel.cpp:268-282): ``(1-a)*bg + a*255*color``
    where ``zbuf > DEPTH_INIT``, ``bg`` elsewhere; ``reverse`` flips the
    rows. As in the JAX package's jitted blend, ``alpha`` is an f32 scalar,
    the sum is f32, and the cast to uint8 saturates with NaN -> 0 (XLA's
    convert): torch's own float -> uint8 cast wraps, so the sum is cleaned
    and clamped to [0, 255] before it truncates."""
    mask = (zbuf > DEPTH_INIT)[..., None]
    a = torch.tensor(alpha, dtype=torch.float32, device=bg_u8.device)
    blended = (1.0 - a) * bg_u8.float() + (a * 255.0) * color.float()
    blended = torch.nan_to_num(blended, nan=0.0).clamp(0.0, 255.0)
    out = torch.where(mask, blended.to(torch.uint8), bg_u8)
    return out.flip(0) if reverse else out
