"""Host crop geometry: bbox squaring and the zero-padded crop.

Counterpart of ``synergynet_tpu/mm3d/crop.py``, with the reference's
semantics:

- ``square_box``: a detector rect -> a square roi whose margin is 1.2x the
  rect's *y-extent*, halved with floor division (reference
  synergy3DMM.py:181-185);
- ``crop_img``: the roi rounded to integers with Python's ``round`` (half
  to even: the roi comes from float64 math, and a .5 is common), cropped
  with zeros where it leaves the image (reference
  utils/inference.py:95-125), also where it misses the image entirely.

The packaged API crops on the device (:mod:`synergynet_tpu_torch.ops.resize`)
with the same integer rois; :func:`crop_rect` is the rounding both use.
"""

from __future__ import annotations

import numpy as np


def square_box(rect) -> np.ndarray:
    """[xmin, ymin, xmax, ymax, ...] -> square roi_box [sx, sy, ex, ey]
    (float64)."""
    rect = np.asarray(rect, np.float64)
    hc = (rect[1] + rect[3]) / 2
    wc = (rect[0] + rect[2]) / 2
    side = rect[3] - rect[1]
    margin = side * 1.2 // 2
    return np.array([wc - margin, hc - margin, wc + margin, hc + margin],
                    np.float64)


def crop_rect(roi_box) -> tuple:
    """The integer crop (sx, sy, ex, ey) of ``roi_box`` [sx, sy, ex, ey,
    ...], each rounded half to even."""
    return tuple(int(round(float(v))) for v in np.asarray(roi_box)[:4])


def crop_img(img: np.ndarray, roi_box) -> np.ndarray:
    """Zero-padded crop of ``img`` at ``roi_box`` [sx, sy, ex, ey, ...]:
    the image's pixels where the crop overlaps it, zeros elsewhere. A crop
    that misses the image entirely is all zeros (the JAX package's and the
    reference's ``crop_img`` slice with the unclamped far edge there, and
    raise or wrap around instead)."""
    h, w = img.shape[:2]
    sx, sy, ex, ey = crop_rect(roi_box)
    res = np.zeros((ey - sy, ex - sx) + img.shape[2:], dtype=np.uint8)
    x0, x1 = max(sx, 0), min(ex, w)
    y0, y1 = max(sy, 0), min(ey, h)
    if x1 > x0 and y1 > y0:
        res[y0 - sy:y1 - sy, x0 - sx:x1 - sx] = img[y0:y1, x0:x1]
    return res
