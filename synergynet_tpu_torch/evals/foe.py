"""A copy of ``synergynet_tpu/evals/foe.py`` (numpy only; the port keeps
its own).

Face-orientation estimation MAE on AFLW2000-3D.

Re-derivation of reference benchmark.py:183-216 (``benchmark_FOE``, following
FSA-Net): samples whose |yaw| > 99 deg are skipped; the decoded [rx, ry, rz]
angles are reordered by swapping the first two entries to match the
ground-truth pitch-yaw-roll convention (the reference comment reads "we
decode raw-pitch-yaw order", benchmark.py:204); MAE is the per-angle mean
absolute difference, with the headline being the mean of the three.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def derive_skip_indices(yaws_deg: np.ndarray,
                        limit: float = 99.0) -> np.ndarray:
    """Indices of samples excluded from FOE: |yaw| > 99 deg (FSA-Net rule).

    The reference ships these as a precomputed file
    (``ALFW2000-3D_pose_3ANG_skip.npy``, benchmark.py:187-195) but the rule
    it encodes is just the yaw cut documented at benchmark.py:183; this
    derives them from the ground-truth yaw list
    (``AFLW2000-3D.pose.npy``, benchmark_aflw2000.py:14) so the eval runs
    without the preprocessed artifact.
    """
    yaws = np.asarray(yaws_deg, np.float64).reshape(-1)
    return np.nonzero(np.abs(yaws) > limit)[0]


def exclude_by_yaw(gt_angles_pyr_all: np.ndarray,
                   yaws_deg: np.ndarray,
                   limit: float = 99.0) -> np.ndarray:
    """Full (N, 3) GT pose -> the kept-rows array the reference precomputes
    as ``ALFW2000-3D_pose_3ANG_excl.npy`` (benchmark.py:187-193)."""
    gt = np.asarray(gt_angles_pyr_all, np.float64)
    keep = np.setdiff1d(np.arange(gt.shape[0]),
                        derive_skip_indices(yaws_deg, limit))
    return gt[keep]


def foe_mae(pred_angles: np.ndarray, gt_angles_pyr: np.ndarray,
            skip_indices: Optional[np.ndarray] = None) -> Dict:
    """pred_angles: (N, 3) decoded [rx, ry, rz] (degrees) for ALL samples;
    gt_angles_pyr: (M, 3) ground truth in [pitch, yaw, roll] order for the
    kept samples; skip_indices: indices into pred to drop (|yaw|>99 rule).
    """
    pred = np.asarray(pred_angles, np.float64)
    if skip_indices is not None and len(skip_indices):
        keep = np.setdiff1d(np.arange(pred.shape[0]), np.asarray(skip_indices))
        pred = pred[keep]
    # swap -> [pitch, yaw, roll]
    pred = pred[:, [1, 0, 2]]
    gt = np.asarray(gt_angles_pyr, np.float64)
    if pred.shape != gt.shape:
        raise ValueError(f"shape mismatch pred {pred.shape} vs gt {gt.shape}")
    per_angle = np.mean(np.abs(pred - gt), axis=0)
    return {
        "mae_mean": float(np.mean(per_angle)),
        "mae_yaw": float(per_angle[1]),
        "mae_pitch": float(per_angle[0]),
        "mae_roll": float(per_angle[2]),
    }


def format_foe_report(r: Dict) -> str:
    """Format-compatible report string (reference benchmark.py:211-215)."""
    return ("Mean MAE = %3.3f (in deg), [yaw,pitch,roll] = "
            "[%3.3f, %3.3f, %3.3f]" %
            (r["mae_mean"], r["mae_yaw"], r["mae_pitch"], r["mae_roll"]))
