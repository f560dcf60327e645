"""Batched training augmentation on the device, inside the train step.

Counterpart of ``synergynet_tpu/data/device_augment.py``: per-sample
brightness, contrast and saturation factors, the clip to [0, 255], the
5-px border zero and the occlusion patterns, as elementwise tensor ops on
the whole batch, so the host only ships uint8 crops.

Divergences from the host path (:mod:`synergynet_tpu_torch.data.
transforms`, which stays the bit-faithful option), as in the JAX module:

- the chain stays in float, where PIL rounds to uint8 after every op;
- the op order is one of :data:`_PERMS` per batch, not per sample.

The draws are split from the arithmetic: :func:`augment_from` takes the
factors, the op order, the occlusion coins and kinds; :func:`device_augment`
draws them. The order is drawn on the host from the step's seed and the
per-sample draws on the images' device from a generator seeded by it, so
the step branches on no device value and makes no host sync.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from synergynet_tpu_torch.data.transforms import _LUMA

_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
N_OCCLUSIONS = 7


def _luma(img: torch.Tensor) -> torch.Tensor:
    """``img @ _LUMA`` summed as a chain of fused multiply-adds, as XLA's
    dot sums it: ``fma(x2, w2, fma(x1, w1, x0 * w0))`` with each step
    rounded once to float32 (a float32 product is exact in float64). The
    gray is rounded to an integer next, so a sum in another order would
    move whole levels where it lands near a half."""
    w0, w1, w2 = (float(w) for w in _LUMA)
    x = img.to(torch.float64)
    acc = (img[..., 0] * w0).to(torch.float64)
    acc = (x[..., 1] * w1 + acc).to(torch.float32).to(torch.float64)
    return (x[..., 2] * w2 + acc).to(torch.float32)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """Per-sample mean over (H, W) as XLA takes it: the sum times 1/N."""
    return x.sum(dim=(1, 2)) * (1.0 / (x.shape[1] * x.shape[2]))


def _apply(img, scale, i, f):
    """Op ``i`` (1 contrast, 2 saturation) with factor ``f`` (B,) on
    ``img * scale``, where ``scale`` is a brightness factor (B, 1, 1, 1)
    not applied yet, or None. The blend ``base + (x - base) * f`` is
    rounded as XLA's fused multiply-adds round it: ``x - base`` once (with
    a pending brightness, ``img * scale - base`` once), then the product
    plus ``base`` once; float32 products are exact in float64."""
    x = img if scale is None else img * scale
    if i == 1:
        base = torch.round(_mean(_luma(x)))[:, None, None, None]
    else:
        base = torch.round(_luma(x))[..., None]
    if scale is None:
        d = img - base
    else:
        d = (img.to(torch.float64) * scale.to(torch.float64)
             - base).to(torch.float32)
    return (d.to(torch.float64) * f[:, None, None, None].to(torch.float64)
            + base).to(torch.float32)


def occlusion_masks(h: int, w: int, border: int, device) -> Tuple[
        torch.Tensor, torch.Tensor]:
    """(interior (H, W) bool, the 7 occlusion keep-masks (7, H, W) bool):
    up-left, up-right, down-left, up-left again (the reference's
    ``rdown`` keeps the top-left quadrant, quirk Q2), left, right,
    centre."""
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    interior = ((yy >= border) & (yy < h - border)
                & (xx >= border) & (xx < w - border))
    up, down = yy < h // 2, yy >= h // 2
    left, right = xx < w // 2, xx >= w // 2
    center = ((yy >= h // 4) & (yy < h - h // 4)
              & (xx >= w // 4) & (xx < w - w // 4))
    masks = torch.stack([m.expand(h, w) for m in (
        up & left, up & right, down & left, up & left, left, right,
        center)])
    return interior, masks


def augment_from(images_u8: torch.Tensor, f: torch.Tensor,
                 perm: Sequence[int], occlude: torch.Tensor,
                 kind: torch.Tensor, border: int = 5) -> torch.Tensor:
    """The augmentation given its draws: (B, H, W, 3) uint8 images, factors
    (B, 3) (brightness, contrast, saturation), the op order ``perm`` (a
    permutation of 0, 1, 2), occlusion coins (B,) bool and kinds (B,) in
    [0, 7) -> float32 in [0, 255]."""
    _, h, w, _ = images_u8.shape
    img = images_u8.to(torch.float32)
    scale = None                  # brightness (op 0), folded into the next
    for i in perm:
        if i == 0:
            scale = f[:, 0, None, None, None]
        else:
            img, scale = _apply(img, scale, i, f[:, i]), None
    if scale is not None:
        img = img * scale
    img = torch.clamp(img, 0.0, 255.0)
    interior, masks = occlusion_masks(h, w, border, img.device)
    keep = torch.where(occlude[:, None, None], masks[kind], interior)
    keep = keep & interior
    return img * keep[..., None]


def device_augment(images_u8: torch.Tensor, seed: int, *,
                   jitter: Tuple[float, float, float] = (0.4, 0.4, 0.4),
                   border: int = 5,
                   occlusion_prob: float = 0.01) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> augmented float32 in [0, 255], on the images'
    device. ``seed`` picks the op order (host numpy) and seeds a
    generator on the device for the per-sample factors (uniform in
    [max(0, 1 - j), 1 + j)), occlusion coins (with ``occlusion_prob``) and
    kinds. The caller normalizes afterwards ((x - 127.5) / 128); the train
    step does so when built with ``augment=``."""
    b = images_u8.shape[0]
    dev = images_u8.device
    perm = _PERMS[int(np.random.default_rng(seed).integers(len(_PERMS)))]
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((b, 3), generator=gen, device=dev)
    # Column by column with Python scalars: a host-made tensor would be a
    # blocking copy to the device.
    f = torch.stack([u[:, i] * (1 + j - max(0.0, 1 - j)) + max(0.0, 1 - j)
                     for i, j in enumerate(jitter)], dim=1)
    occlude = torch.rand((b,), generator=gen, device=dev) < occlusion_prob
    kind = torch.randint(0, N_OCCLUSIONS, (b,), generator=gen, device=dev)
    return augment_from(images_u8, f, perm, occlude, kind, border)
