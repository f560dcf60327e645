"""Synthetic 300W-LP / AFLW2000-style data for end-to-end runs and tests.

Counterpart of ``synergynet_tpu/data/synthetic.py``: parameters are
sampled in whitened space, decoded through the ``ParamPack`` to landmarks,
and the landmarks are painted into 120x120 crops as 2x2 dots over noise
("dots", the JAX default config's appearance). The numpy draws are the
JAX module's, call for call; the landmark decode runs in the port (fp32,
on the card unless the caller asks for the CPU), so a dot can land one
pixel off where a landmark coordinate sits within rounding of a
half-pixel.

The "shaded" appearance renders the lit surface
(:mod:`synergynet_tpu_torch.data.shaded`). :class:`GeneratedCropDataset`
streams crops made per index for datasets too large to hold (the 680K-crop
300W-LP scale).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.data import keyed, shaded
from synergynet_tpu_torch.mm3d import (ParamPack, load_param_pack,
                                       pose_from_param, rescale_to_roi)


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


def make_crops_with_params(n: int, pack: Optional[ParamPack] = None,
                           seed: int = 0, size: int = 120,
                           appearance: str = "dots", device="cuda"
                           ) -> Dict[str, np.ndarray]:
    """n synthetic (crop, param62) pairs + decoded GT landmarks:
    ``{"images" (n, size, size, 3) uint8, "params" (n, 62) f32,
    "landmarks" (n, 3, 68) f32}``, host arrays. ``appearance``: "dots" (68
    dots over noise) or "shaded" (:func:`shaded.make_shaded_crops`). The
    landmarks are decoded (and shaded crops rendered) on ``device``."""
    if appearance not in ("dots", "shaded"):
        raise ValueError(f"unknown appearance {appearance!r}")
    device = resolve_device(device)
    pack = pack or load_param_pack()
    if appearance == "shaded":
        return shaded.make_shaded_crops(n, pack, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    params = sample_params(rng, n)
    lmk = shaded.decode_chunked(params, pack, device)
    # uint8 end to end: max value 89 + 29 < 256 needs no clip.
    base = rng.integers(40, 90, (n, 1, 1, 3), dtype=np.uint8)
    noise = rng.integers(0, 30, (n, size, size, 3), dtype=np.uint8)
    images = base + noise
    _paint_landmarks(images, lmk)
    return {"images": images, "params": params, "landmarks": lmk}


def make_synthetic_aflw2000(n: int, pack: Optional[ParamPack] = None,
                            seed: int = 1, appearance: str = "dots",
                            device="cuda") -> Dict[str, np.ndarray]:
    """AFLW2000-protocol eval pack: crops, GT 68-pt landmarks in original
    image coordinates, roi boxes, GT yaw list, and pitch-yaw-roll pose GT
    with the |yaw|>99 skip indices (reference benchmark.py:183-216). The
    crops are made on ``device`` (:func:`make_crops_with_params`)."""
    pack = pack or load_param_pack()
    d = make_crops_with_params(n, pack, seed=seed, appearance=appearance,
                               device=device)
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


class GeneratedCropDataset:
    """Streaming variant of :func:`make_crops_with_params`: each crop is
    made on demand from ``(seed, index)``, the same in every epoch, while
    the 62-d parameters are drawn in bulk and the landmarks decoded in bulk
    on first use. The 680K-crop 300W-LP scale (~29 GB of uint8 crops)
    cannot be held; its parameters are 170 MB.

    Items follow :class:`ArrayDataset`'s contract (uint8 HWC image,
    param62); the loader's per-(epoch, index) rng drives only the optional
    transform, never the crop. "dots" crops are a row of a background bank
    (997 base-plus-noise rows drawn from ``seed + 1``, the JAX package's
    draws call for call) with the landmark dots painted; "shaded" crops are
    rendered as :func:`shaded.make_shaded_crops` renders them, so both
    paths give the same pixels for the same (seed, index) and device. The
    landmarks are decoded and the shaded crops rendered on ``device``, the
    card unless the caller asks for the CPU.
    """

    def __init__(self, n: int, pack: Optional[ParamPack] = None,
                 seed: int = 0, size: int = 120, transform=None,
                 appearance: str = "dots", device="cuda"):
        if appearance not in ("dots", "shaded"):
            raise ValueError(f"unknown appearance {appearance!r}")
        self.device = resolve_device(device)
        self.params = sample_params(np.random.default_rng(seed), n)
        self._lmk = None
        self._pack = pack or load_param_pack()
        self.seed = seed
        self.size = size
        self.transform = transform
        self.appearance = appearance
        # One shaded render at a time: each render sets and restores the
        # process-wide TF32 flags (``full_fp32``), and on the CPU it
        # already spreads over the intra-op threads, which the loader's
        # slab threads would otherwise oversubscribe.
        self._render_lock = threading.Lock()
        self._lmk_lock = threading.Lock()
        bank_rng = np.random.default_rng(seed + 1)
        base = bank_rng.integers(40, 90, (997, 1, 3))
        noise = bank_rng.integers(0, 30, (997, size * size, 3))
        self._bg_bank = (base + noise).astype(np.uint8).reshape(997, -1)

    @property
    def lmk(self) -> np.ndarray:
        """(n, 3, 68) GT landmarks, decoded on first use in
        :data:`shaded.DECODE_CHUNK` rows on ``device`` (the generative
        resident path reads only ``params`` and decodes on the card)."""
        with self._lmk_lock:
            if self._lmk is None:
                self._lmk = shaded.decode_chunked(self.params, self._pack,
                                                  self.device)
        return self._lmk

    def __len__(self) -> int:
        return len(self.params)

    def generate_images(self, indices: np.ndarray) -> np.ndarray:
        """(b,) indices -> (b, size, size, 3) uint8 crops."""
        idx = np.asarray(indices, np.int64)
        if self.appearance == "shaded":
            return self._generate_shaded(idx)
        images = self._bg_bank[idx % self._bg_bank.shape[0]
                               ].reshape(len(idx), self.size, self.size, 3)
        _paint_landmarks(images, self.lmk[idx])
        return images

    def _generate_shaded(self, idx: np.ndarray) -> np.ndarray:
        lmk = self.lmk[idx]
        with self._render_lock:
            return shaded.render_chunked(lmk, idx, keyed.make_key(self.seed),
                                         self.device)

    def fetch_batch(self, indices: np.ndarray):
        """Vectorized (images, params) batch: the loader's fast path, used
        when no host transform is configured."""
        idx = np.asarray(indices)
        return self.generate_images(idx), self.params[idx]

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None):
        img = self.generate_images(np.asarray([index]))[0]
        if self.transform is not None:
            img = self.transform(img, rng)
        return img, self.params[index]
