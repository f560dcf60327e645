"""Visualization: 68-landmark plots, pose axes and detector boxes.

Counterpart of ``synergynet_tpu/pipeline/draw.py``: the reference's
matplotlib / cv2 helpers (utils/inference.py:159-244, FaceBoxes/
FaceBoxes.py:32-44) with their visual conventions -- green landmark
polylines per facial region with closed eye and mouth loops; x red, y
green, z blue axes anchored at the nose tip, their length from the
landmarks' extent. Images and landmarks are numpy arrays or CPU tensors
(a tensor is drawn on in place through its numpy view). matplotlib and
cv2 are imported when a function draws, and a missing one raises an error
that names it.
"""

from __future__ import annotations

from math import cos, sin, sqrt
from typing import Optional, Sequence

import numpy as np
import torch

from synergynet_tpu_torch.core.optional import import_cv2, import_pyplot

# Region boundaries of the 68-point markup (utils/inference.py:172).
LANDMARK_GROUPS = [0, 17, 22, 27, 31, 36, 42, 48, 60, 68]
CLOSE_PAIRS = [(41, 36), (47, 42), (59, 48), (67, 60)]


def _np(x) -> np.ndarray:
    """A CPU tensor's numpy view (shared memory), or ``np.asarray(x)``."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def draw_landmarks(img_bgr, pts, wfp: Optional[str] = None, dpi: int = 200):
    """Plot one (3+, 68) landmark set, or a list of them, over the image;
    saves to ``wfp`` when given (and returns None), else returns the
    matplotlib figure, which the caller closes."""
    plt = import_pyplot("draw_landmarks")
    img_bgr = _np(img_bgr)
    height, width = img_bgr.shape[:2]
    base = 6.4
    fig = plt.figure(figsize=(base, height / width * base))
    plt.imshow(img_bgr[:, :, ::-1])
    plt.subplots_adjust(left=0, right=1, top=1, bottom=0)
    plt.axis("off")

    if not isinstance(pts, (tuple, list)):
        pts = [pts]
    for p in map(_np, pts):
        alpha, markersize, lw = 0.8, 1.5, 0.7
        color = markeredgecolor = "green"
        for i1, i2 in CLOSE_PAIRS:
            plt.plot([p[0, i1], p[0, i2]], [p[1, i1], p[1, i2]],
                     color=color, lw=lw, alpha=alpha - 0.1)
        for left, right in zip(LANDMARK_GROUPS[:-1], LANDMARK_GROUPS[1:]):
            plt.plot(p[0, left:right], p[1, left:right], color=color,
                     lw=lw, alpha=alpha - 0.1)
            plt.plot(p[0, left:right], p[1, left:right], marker="o",
                     linestyle="None", markersize=markersize, color=color,
                     markeredgecolor=markeredgecolor, alpha=alpha)
    if wfp is not None:
        plt.savefig(wfp, dpi=dpi)
        plt.close(fig)
        return None
    return fig


def draw_axis(img_bgr, yaw: float, pitch: float, roll: float, pts68,
              thickness: int = 4) -> np.ndarray:
    """Draw the head-pose axes in place (utils/inference.py:199-244),
    anchored at landmark 30 (the nose tip), 0.5 * sqrt(bbox area) long;
    returns the drawn image as numpy."""
    cv2 = import_cv2("draw_axis")
    img = _np(img_bgr)
    pts68 = _np(pts68)
    # In the angles' own dtype, as the JAX package computes them.
    pitch_r = _np(pitch) * np.pi / 180
    yaw_r = -(_np(yaw) * np.pi / 180)
    roll_r = _np(roll) * np.pi / 180

    tdx = float(pts68[0, 30])
    tdy = float(pts68[1, 30])
    minx, maxx = float(np.min(pts68[0])), float(np.max(pts68[0]))
    miny, maxy = float(np.min(pts68[1])), float(np.max(pts68[1]))
    size = sqrt((maxx - minx) * (maxy - miny)) * 0.5

    x1 = size * (cos(yaw_r) * cos(roll_r)) + tdx
    y1 = size * (cos(pitch_r) * sin(roll_r)
                 + cos(roll_r) * sin(pitch_r) * sin(yaw_r)) + tdy
    x2 = size * (-cos(yaw_r) * sin(roll_r)) + tdx
    y2 = size * (cos(pitch_r) * cos(roll_r)
                 - sin(pitch_r) * sin(yaw_r) * sin(roll_r)) + tdy
    x3 = size * sin(yaw_r) + tdx
    y3 = size * (-cos(yaw_r) * sin(pitch_r)) + tdy

    cv2.line(img, (int(tdx), int(tdy)), (int(x1), int(y1)),
             (0, 0, 255), thickness)
    cv2.line(img, (int(tdx), int(tdy)), (int(x2), int(y2)),
             (0, 255, 0), thickness)
    cv2.line(img, (int(tdx), int(tdy)), (int(x3), int(y3)),
             (255, 0, 0), thickness)
    return img


def viz_bbox(img_bgr, dets: Sequence, vis_thresh: float = 0.5) -> np.ndarray:
    """Draw detector boxes with their scores in place (reference
    FaceBoxes/FaceBoxes.py:32-44); returns the drawn image as numpy."""
    cv2 = import_cv2("viz_bbox")
    img = _np(img_bgr)
    for b in dets:
        if b[4] < vis_thresh:
            continue
        text = f"{b[4]:.4f}"
        bi = list(map(int, b[:4]))
        cv2.rectangle(img, (bi[0], bi[1]), (bi[2], bi[3]), (0, 0, 255), 2)
        cv2.putText(img, text, (bi[0], bi[1] + 12),
                    cv2.FONT_HERSHEY_DUPLEX, 0.5, (255, 255, 255))
    return img
