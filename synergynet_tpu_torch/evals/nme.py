"""A copy of ``synergynet_tpu/evals/nme.py`` (numpy only; the port keeps
its own).

AFLW2000-3D landmark NME: bbox-diagonal-normalized error by yaw bin.

Vectorized re-derivation of the reference eval (benchmark_aflw2000.py:107-139
``calc_nme`` and :22-87 ``ana``/``ana_msg``, which follow 3DDFA): predicted
crop-space landmarks are rescaled into original-image coordinates via the
per-sample roi box, the per-point L2 error (x,y only) is averaged, and
normalized by sqrt(bbox_w * bbox_h) of the ground-truth points. Aggregation
buckets |yaw| into [0,30], (30,60], (60,90], reports mean/std per bin (x100)
and the mean-of-bin-means headline.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

STD_SIZE = 120


def calc_nme(pts68_fit: np.ndarray, pts68_gt: np.ndarray,
             roi_boxes: np.ndarray) -> np.ndarray:
    """Per-sample NME.

    pts68_fit: (N, 3, 68) or (N, 2, 68) crop-space predictions.
    pts68_gt:  (N, >=2, 68) original-image ground truth.
    roi_boxes: (N, 4) [sx, sy, ex, ey].
    Returns (N,) float32 NME (fraction, not percent).
    """
    pts68_fit = np.asarray(pts68_fit, np.float64)[:, :2, :]
    pts68_gt = np.asarray(pts68_gt, np.float64)[:, :2, :]
    roi = np.asarray(roi_boxes, np.float64)

    scale_x = (roi[:, 2] - roi[:, 0]) / STD_SIZE
    scale_y = (roi[:, 3] - roi[:, 1]) / STD_SIZE
    fit = np.empty_like(pts68_fit)
    fit[:, 0, :] = pts68_fit[:, 0, :] * scale_x[:, None] + roi[:, 0, None]
    fit[:, 1, :] = pts68_fit[:, 1, :] * scale_y[:, None] + roi[:, 1, None]

    minx = pts68_gt[:, 0, :].min(1)
    maxx = pts68_gt[:, 0, :].max(1)
    miny = pts68_gt[:, 1, :].min(1)
    maxy = pts68_gt[:, 1, :].max(1)
    llength = np.sqrt((maxx - minx) * (maxy - miny))

    dis = np.sqrt(((fit - pts68_gt) ** 2).sum(1)).mean(1)
    return (dis / llength).astype(np.float32)


def analyze_by_yaw(nme_list: np.ndarray, yaws: np.ndarray) -> Dict:
    """Yaw-bin aggregation (reference ana_msg). Values in percent."""
    nme_list = np.asarray(nme_list)
    yaw_abs = np.abs(np.asarray(yaws))[: nme_list.shape[0]]
    bins = {
        "[ 0, 30]": nme_list[yaw_abs <= 30],
        "[30, 60]": nme_list[(yaw_abs > 30) & (yaw_abs <= 60)],
        "[60, 90]": nme_list[yaw_abs > 60],
    }
    out = {}
    means = []
    for name, vals in bins.items():
        mean = float(np.mean(vals) * 100) if vals.size else float("nan")
        std = float(np.std(vals) * 100) if vals.size else float("nan")
        out[name] = {"mean": mean, "std": std, "count": int(vals.size)}
        if vals.size:
            means.append(mean)
    # Empty bins are excluded from the headline (real AFLW2000 populates all
    # three; small/synthetic sets may not).
    out["mean_of_means"] = float(np.mean(means)) if means else float("nan")
    out["std_of_means"] = float(np.std(means)) if means else float("nan")
    return out


def format_nme_report(analysis: Dict) -> str:
    """Format-compatible NME report (reference benchmark_aflw2000.py:79-87)."""
    lines = ["", "Facial Alignment on AFLW2000-3D (NME):"]
    for name in ("[ 0, 30]", "[30, 60]", "[60, 90]"):
        b = analysis[name]
        lines.append(f"{name}\tMean: {b['mean']:.3f}, Std: {b['std']:.3f}")
    lines.append(f"[ 0, 90]\tMean: {analysis['mean_of_means']:.3f}, "
                 f"Std: {analysis['std_of_means']:.3f}")
    return "\n".join(lines)
