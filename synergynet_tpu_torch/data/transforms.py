"""Host-side training augmentations (numpy, per-sample).

A copy of ``synergynet_tpu/data/transforms.py`` (the port keeps its own,
as it imports nothing of the JAX package), with the same rng calls in the
same order, so a seeded sample augments to the same bytes in both
packages. Only :func:`normalize_images` differs: it takes a torch tensor.

Re-derivations of the reference's transform stack (reference
utils/ddfa.py:122-244,344-391 and its composition at main_train.py:196-205):

    ColorJitter(0.4, 0.4, 0.4) -> ToTensor -> CenterCrop(5) -> Normalize

Here color jitter and the border/occlusion zeroing run on uint8 HWC arrays on
the host; the (x - 127.5) / 128 normalization runs on the device in the
train step (one less float pass over the batch on the host, and the zeroed
borders normalize to the same -0.996 constant as the reference's
zero-after-ToTensor ordering).

Faithful quirks:
- The reference feeds BGR arrays to PIL as if RGB, so the luma weights of
  contrast/saturation land on swapped channels; reproduced by applying the
  (0.299, 0.587, 0.114) weights to the channels as given.
- ``rdown`` duplicates ``lup`` (keeps the top-left quadrant — reference
  utils/ddfa.py:204-207, quirk Q2), so "keep bottom-right" never occurs.
- Occlusion patterns fire with probability 0.01 *after* the 5-px border zero.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# PIL "L" luma weights, applied to channel order as-given (BGR in practice).
_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    """PIL ImageEnhance blend: degenerate * (1 - f) + img * f, clipped."""
    out = a.astype(np.float32) * (1.0 - factor) + b.astype(np.float32) * factor
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(np.zeros_like(img), img, factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    # PIL: blend with the mean of the grayscale image (rounded to int).
    gray_mean = float(np.round(
        (img.astype(np.float32) @ _LUMA).mean()))
    return _blend(np.full_like(img, np.uint8(np.clip(gray_mean, 0, 255))),
                  img, factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (img.astype(np.float32) @ _LUMA)
    gray3 = np.repeat(np.round(gray)[..., None], 3, axis=-1)
    return _blend(np.clip(gray3, 0, 255).astype(np.uint8), img, factor)


def _rgb_to_hsv(arr: np.ndarray) -> np.ndarray:
    """PIL ``convert('HSV')``, byte-exact (verified over the full 256^3 RGB
    cube vs Pillow). PIL's C computes the per-channel fractions in C float
    but the branch expressions ``2.0 + rc - bc`` / ``4.0 + gc - rc`` and the
    final ``fmod(h/6 + 1, 1) * 255`` in double, storing h back to float in
    between — the mixed precision below reproduces that rounding exactly."""
    a = arr.astype(np.float32)
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    maxc = np.max(a, -1)
    minc = np.min(a, -1)
    uv = maxc.astype(np.uint8)
    cr = (maxc - minc).astype(np.float32)
    crs = np.where(cr == 0, 1.0, cr).astype(np.float32)
    s = (cr / np.where(maxc == 0, 1.0, maxc)).astype(np.float32)
    rc = ((maxc - r) / crs).astype(np.float32)
    gc = ((maxc - g) / crs).astype(np.float32)
    bc = ((maxc - b) / crs).astype(np.float32)
    rc64, gc64, bc64 = (x.astype(np.float64) for x in (rc, gc, bc))
    h = np.where(r == maxc, (bc - gc).astype(np.float32),
                 np.where(g == maxc, (2.0 + rc64 - bc64).astype(np.float32),
                          (4.0 + gc64 - rc64).astype(np.float32)))
    hm = np.mod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(np.float32)
    uh = np.clip((hm.astype(np.float64) * 255.0).astype(np.int32),
                 0, 255).astype(np.uint8)
    us = np.clip((s.astype(np.float64) * 255.0).astype(np.int32),
                 0, 255).astype(np.uint8)
    same = minc == maxc
    uh = np.where(same, np.uint8(0), uh)
    us = np.where(same, np.uint8(0), us)
    return np.stack([uh, us, uv], -1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """PIL ``Image.merge('HSV', ...).convert('RGB')``, byte-exact (verified
    over the full 256^3 HSV cube vs Pillow): all-double sector math."""
    h = hsv[..., 0].astype(np.float64) / 255.0
    s = hsv[..., 1].astype(np.float64) / 255.0
    v = hsv[..., 2].astype(np.float64)
    h6 = h * 6.0
    i = h6.astype(np.int32)
    f = h6 - i
    p = np.clip(np.round(v * (1.0 - s)).astype(np.int32), 0, 255)
    q = np.clip(np.round(v * (1.0 - s * f)).astype(np.int32), 0, 255)
    t = np.clip(np.round(v * (1.0 - s * (1.0 - f))).astype(np.int32), 0, 255)
    im = np.mod(i, 6)
    uv = hsv[..., 2].astype(np.int32)
    sel = [im == 0, im == 1, im == 2, im == 3, im == 4]
    r = np.select(sel, [uv, q, p, p, t], uv)
    g = np.select(sel, [t, uv, uv, q, p], p)
    b = np.select(sel, [p, p, t, uv, uv], q)
    out = np.stack([r, g, b], -1).astype(np.uint8)
    return np.where((hsv[..., 1] == 0)[..., None], hsv[..., 2:3], out)


def adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """Reference ``adjust_hue`` (utils/ddfa.py:64-84): PIL RGB->HSV, shift
    the H channel by ``factor * 255`` with uint8 wraparound, HSV->RGB.
    ``factor`` in [-0.5, 0.5]. The reference feeds BGR arrays as if RGB —
    applied to channels as-given, like the other jitter ops."""
    if not -0.5 <= factor <= 0.5:
        raise ValueError(f"hue factor {factor} not in [-0.5, 0.5]")
    hsv = _rgb_to_hsv(img)
    # The reference's ``np.uint8(hue_factor * 255)`` relied on old numpy's
    # truncate-then-wrap for negative factors; modern numpy raises, so wrap
    # explicitly (identical value), and the in-place uint8 add still wraps
    # across the hue circle like the reference's.
    shift = np.uint8(int(factor * 255) % 256)
    with np.errstate(over="ignore"):
        hsv[..., 0] += shift
    return _hsv_to_rgb(hsv)


class ColorJitter:
    """Random brightness/contrast/saturation/hue in a random order
    (reference utils/ddfa.py:344-382). Hue defaults off like the reference's
    3-argument call (main_train.py:204)."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, hue: float = 0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, img: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        ops = []
        if self.brightness > 0:
            f = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im, f=f: adjust_brightness(im, f))
        if self.contrast > 0:
            f = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im, f=f: adjust_contrast(im, f))
        if self.saturation > 0:
            f = rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im, f=f: adjust_saturation(im, f))
        if self.hue > 0:
            f = rng.uniform(-self.hue, self.hue)
            ops.append(lambda im, f=f: adjust_hue(im, f))
        rng.shuffle(ops)
        for op in ops:
            img = op(img)
        return img


class BorderOcclusion:
    """5-px border zero + rare occlusion patterns
    (reference CenterCrop, utils/ddfa.py:162-244). HWC uint8 in/out."""

    PATTERNS = ("lup", "rup", "ldown", "rdown", "lhalf", "rhalf", "center")

    def __init__(self, maximum: int = 5, prob: float = 0.01,
                 mode: str = "train"):
        self.maximum = maximum
        self.prob = prob
        self.mode = mode

    @staticmethod
    def _apply_pattern(img: np.ndarray, name: str) -> np.ndarray:
        h, w = img.shape[:2]
        out = np.zeros_like(img)
        if name in ("lup", "rdown"):          # rdown == lup (quirk Q2)
            out[: h // 2, : w // 2] = img[: h // 2, : w // 2]
        elif name == "rup":
            out[: h // 2, w // 2:] = img[: h // 2, w // 2:]
        elif name == "ldown":
            out[h // 2:, : w // 2] = img[h // 2:, : w // 2]
        elif name == "lhalf":
            out[:, : w // 2] = img[:, : w // 2]
        elif name == "rhalf":
            out[:, w // 2:] = img[:, w // 2:]
        elif name == "center":
            out[h // 4: -(h // 4), w // 4: -(w // 4)] = \
                img[h // 4: -(h // 4), w // 4: -(w // 4)]
        return out

    def __call__(self, img: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        m = self.maximum
        h, w = img.shape[:2]
        out = np.zeros_like(img)
        out[m:h - m, m:w - m] = img[m:h - m, m:w - m]
        if self.mode == "train" and rng.random() < self.prob:
            out = self._apply_pattern(
                out, self.PATTERNS[rng.integers(0, len(self.PATTERNS))])
        return out


class TrainTransform:
    """The full reference augmentation chain on uint8 HWC BGR crops."""

    def __init__(self, jitter: Tuple[float, float, float] = (0.4, 0.4, 0.4),
                 border: int = 5, occlusion_prob: float = 0.01):
        self.jitter = ColorJitter(*jitter)
        self.occlude = BorderOcclusion(border, occlusion_prob, mode="train")

    def __call__(self, img: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        return self.occlude(self.jitter(img, rng), rng)


class TestTransform:
    """Eval-time chain: border zero only (reference CenterCrop mode='test',
    benchmark.py:117)."""

    def __init__(self, border: int = 5):
        self.occlude = BorderOcclusion(border, prob=0.0, mode="test")

    def __call__(self, img: np.ndarray, rng=None) -> np.ndarray:
        return self.occlude(img)


def normalize_images(images_u8, mean: float = 127.5, std: float = 128.0):
    """Normalization on the tensor's device (reference Normalize,
    utils/ddfa.py:132-139; std=128 standalone eval vs 130 in-train eval,
    quirk Q6, is the caller's choice)."""
    return (images_u8.float() - mean) / std
