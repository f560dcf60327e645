"""Z-buffer constants, the uint8 blend and the host APIs' argument
handling.

Counterpart of ``synergynet_tpu/render/raster.py``'s depth the z-buffer
starts from and the reference's truncating blend. Its host rasterizers
(``rasterize_buffers``, ``rasterize``, ``rasterize_triangles``) live in
:mod:`synergynet_tpu_torch.render.raster_tiled` beside the kernels they
run.
"""

from __future__ import annotations

import numpy as np
import torch

from synergynet_tpu_torch.core.device import device_constant

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
    a = device_constant(float(alpha), torch.float32, bg_u8.device)
    blended = (1.0 - a) * bg_u8.float() + (a * 255.0) * color.float()
    blended = torch.nan_to_num(blended, nan=0.0).clamp(0.0, 255.0)
    out = torch.where(mask, blended.to(torch.uint8), bg_u8)
    return out.flip(0) if reverse else out


def no_window(window) -> None:
    """Raise unless ``window`` is ``None``: the port's kernels take every
    triangle whole and have no fragment window to set."""
    if window is not None and window != (None, None):
        raise ValueError(f"window {window!r}: the port renders every "
                         "triangle whole and takes no fragment window; "
                         "pass None")


_NUMPY_DTYPE = {torch.float32: np.float32, torch.int32: np.int32,
                torch.uint8: np.uint8}


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """An array-like or tensor as a contiguous ``dtype`` tensor on
    ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(
        x, dtype=_NUMPY_DTYPE[dtype])).to(device)
