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
                alpha: float) -> torch.Tensor:
    """uint8 truncation blend of resolved color into the background
    (reference rasterize_kernel.cpp:268-282): ``(1-a)*bg + a*255*color``,
    truncated to uint8, where ``zbuf > DEPTH_INIT``; ``bg`` elsewhere. The
    JAX package's ``reverse`` flip waits for a caller that needs it."""
    mask = (zbuf > DEPTH_INIT)[..., None]
    blended = ((1.0 - alpha) * bg_u8.float() + alpha * 255.0 * color)
    return torch.where(mask, blended.to(torch.uint8), bg_u8)
