"""Synthetic 300W-LP / AFLW2000-style data for end-to-end runs and tests.

Counterpart of ``synergynet_tpu/data/synthetic.py``: parameters are
sampled in whitened space, decoded through the ``ParamPack`` to landmarks,
and the landmarks are painted into 120x120 crops as 2x2 dots over noise
("dots", the JAX default config's appearance). The numpy draws are the
JAX module's, call for call; the landmark decode runs in the port
(fp32 on the CPU), so a dot can land one pixel off where a landmark
coordinate sits within rounding of a half-pixel.

The "shaded" appearance is not ported yet (ROADMAP.md, queue A: shaded).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from synergynet_tpu_torch.mm3d import (ParamPack, decode_landmarks,
                                       load_param_pack, pose_from_param,
                                       rescale_to_roi)


def sample_params(rng: np.random.Generator, n: int, spread: float = 0.4,
                  pose_spread: float = 1.2) -> np.ndarray:
    """Whitened 62-d parameter vectors. Pose rows get a wider spread so the
    decoded yaw distribution populates all three AFLW2000 yaw bins."""
    p = rng.normal(0, spread, (n, 62)).astype(np.float32)
    p[:, :12] = rng.normal(0, pose_spread, (n, 12)).astype(np.float32)
    return p


def _paint_landmarks(images: np.ndarray, lmk: np.ndarray) -> None:
    """Draw 2x2 bright dots at each landmark (in place). lmk: (N, 3, 68)."""
    n, h, w = images.shape[:3]
    xs = np.clip(np.round(lmk[:, 0]).astype(np.int64), 0, w - 2)
    ys = np.clip(np.round(lmk[:, 1]).astype(np.int64), 0, h - 2)
    for dy in (0, 1):
        for dx in (0, 1):
            flat = (ys + dy) * w + (xs + dx)              # (N, 68)
            for c, val in enumerate((255, 220, 180)):
                ch = images[..., c].reshape(n, -1)
                np.put_along_axis(ch, flat, val, axis=1)


def _decode(params: np.ndarray, pack: ParamPack) -> np.ndarray:
    with torch.no_grad():
        return decode_landmarks(torch.from_numpy(params), pack).numpy()


def make_crops_with_params(n: int, pack: Optional[ParamPack] = None,
                           seed: int = 0, size: int = 120,
                           appearance: str = "dots"
                           ) -> Dict[str, np.ndarray]:
    """n synthetic (crop, param62) pairs + decoded GT landmarks:
    ``{"images" (n, size, size, 3) uint8, "params" (n, 62) f32,
    "landmarks" (n, 3, 68) f32}``."""
    if appearance == "shaded":
        raise NotImplementedError(
            "the shaded synthetic appearance is not ported yet (ROADMAP.md,"
            " queue A: shaded)")
    if appearance != "dots":
        raise ValueError(f"unknown appearance {appearance!r}")
    pack = pack or load_param_pack()
    rng = np.random.default_rng(seed)
    params = sample_params(rng, n)
    lmk = _decode(params, pack)
    # uint8 end to end: max value 89 + 29 < 256 needs no clip.
    base = rng.integers(40, 90, (n, 1, 1, 3), dtype=np.uint8)
    noise = rng.integers(0, 30, (n, size, size, 3), dtype=np.uint8)
    images = base + noise
    _paint_landmarks(images, lmk)
    return {"images": images, "params": params, "landmarks": lmk}


def make_synthetic_aflw2000(n: int, pack: Optional[ParamPack] = None,
                            seed: int = 1, appearance: str = "dots"
                            ) -> Dict[str, np.ndarray]:
    """AFLW2000-protocol eval pack: crops, GT 68-pt landmarks in original
    image coordinates, roi boxes, GT yaw list, and pitch-yaw-roll pose GT
    with the |yaw|>99 skip indices (reference benchmark.py:183-216)."""
    pack = pack or load_param_pack()
    d = make_crops_with_params(n, pack, seed=seed, appearance=appearance)
    rng = np.random.default_rng(seed + 1)
    sx = rng.uniform(0, 300, n)
    sy = rng.uniform(0, 200, n)
    side = rng.uniform(90, 240, n)
    roi = np.stack([sx, sy, sx + side, sy + side], 1).astype(np.float32)
    with torch.no_grad():
        lmk_img = rescale_to_roi(torch.from_numpy(d["landmarks"]),
                                 torch.from_numpy(roi)).numpy()
        angles, _ = pose_from_param(torch.from_numpy(d["params"]), pack)
    angles = angles.numpy()                         # [rx, ry, rz] degrees
    # The protocol's GT pose is [pitch, yaw, roll] (benchmark.py:204).
    pose_gt_pyr = angles[:, [1, 0, 2]]
    yaws = pose_gt_pyr[:, 1]
    skip = np.nonzero(np.abs(yaws) > 99)[0]
    return {
        **d,
        "roi_boxes": roi,
        "pts68_gt": lmk_img,                        # (N, 3, 68) image space
        "yaws": yaws.astype(np.float32),
        "pose_gt_pyr": np.delete(pose_gt_pyr, skip, axis=0).astype(np.float32),
        "skip_indices": skip,
    }
