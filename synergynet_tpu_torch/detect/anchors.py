"""Anchor (prior box) generation and decode for FaceBoxes.

Counterpart of ``synergynet_tpu/detect/anchors.py``: anchors are built once
per canvas size with numpy (16,680 at 720x1088) in the reference's order —
feature maps by stride (32, 64, 128), row-major cells, and within a cell
16 densified 32-px anchors, 4 densified 64-px, one 128-px.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

STEPS = (32, 64, 128)
MIN_SIZES = ((32, 64, 128), (256,), (512,))
VARIANCES = (0.1, 0.2)

# Per-min_size densification offsets (fractions of a step).
_DENSE_OFFSETS = {
    32: (0.0, 0.25, 0.5, 0.75),
    64: (0.0, 0.5),
}


def _cell_templates(min_sizes: Tuple[int, ...], step: int,
                    img_h: int, img_w: int) -> np.ndarray:
    """(T, 4) per-cell anchor templates [ox, oy, w, h]."""
    rows = []
    for ms in min_sizes:
        offs = _DENSE_OFFSETS.get(ms, (0.5,))
        s_kx, s_ky = ms / img_w, ms / img_h
        for oy in offs:
            for ox in offs:
                rows.append((ox, oy, s_kx, s_ky))
    return np.asarray(rows, np.float64)


@lru_cache(maxsize=16)
def generate_anchors(img_h: int, img_w: int) -> np.ndarray:
    """All anchors for an (img_h, img_w) input as a read-only (A, 4)
    float32 array [cx, cy, w, h] in [0, 1] normalized coordinates."""
    out = []
    for step, min_sizes in zip(STEPS, MIN_SIZES):
        fh = math.ceil(img_h / step)
        fw = math.ceil(img_w / step)
        tmpl = _cell_templates(min_sizes, step, img_h, img_w)   # (T, 4)
        jj = np.arange(fw, dtype=np.float64)
        ii = np.arange(fh, dtype=np.float64)
        cx = (jj[None, :, None] + tmpl[None, None, :, 0]) * step / img_w
        cy = (ii[:, None, None] + tmpl[None, None, :, 1]) * step / img_h
        cx = np.broadcast_to(cx, (fh, fw, len(tmpl)))
        cy = np.broadcast_to(cy, (fh, fw, len(tmpl)))
        w = np.broadcast_to(tmpl[None, None, :, 2], cx.shape)
        h = np.broadcast_to(tmpl[None, None, :, 3], cx.shape)
        out.append(np.stack([cx, cy, w, h], -1).reshape(-1, 4))
    arr = np.concatenate(out, 0).astype(np.float32)
    arr.flags.writeable = False      # one cached array serves every caller
    return arr


def num_anchors(img_h: int, img_w: int) -> int:
    total = 0
    for step, min_sizes in zip(STEPS, MIN_SIZES):
        t = sum(len(_DENSE_OFFSETS.get(ms, (0.5,))) ** 2 for ms in min_sizes)
        total += math.ceil(img_h / step) * math.ceil(img_w / step) * t
    return total


def decode_boxes(loc: torch.Tensor, anchors: torch.Tensor,
                 variances=VARIANCES) -> torch.Tensor:
    """Center-variance anchor decode: ``loc`` (..., A, 4) offsets and
    ``anchors`` (A, 4) [cx, cy, w, h] -> (..., A, 4) [x1, y1, x2, y2] in
    normalized units."""
    center = anchors[..., :2] + loc[..., :2] * variances[0] * anchors[..., 2:]
    wh = anchors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    top_left = center - wh / 2
    return torch.cat([top_left, top_left + wh], dim=-1)
