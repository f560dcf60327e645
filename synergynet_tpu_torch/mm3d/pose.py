"""Head-pose math: camera matrix factorisation and Euler angles, batched.

Counterpart of ``synergynet_tpu/mm3d/pose.py``: ``p2srt`` factors the 3x4
camera matrix into scale, rotation and translation; ``matrix_to_euler_deg``
is the reference's ``matrix2angle_corr`` with an explicit, branchless
gimbal-lock case.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from synergynet_tpu_torch.mm3d.assets import ParamPack, STD_SIZE
from synergynet_tpu_torch.mm3d.codec import dewhiten


def p2srt(P: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched (B,3,4) -> (s (B,), R (B,3,3), t3d (B,3))."""
    t3d = P[:, :, 3]
    R1 = P[:, 0:1, :3]
    R2 = P[:, 1:2, :3]
    n1 = torch.linalg.norm(R1, dim=(1, 2))
    n2 = torch.linalg.norm(R2, dim=(1, 2))
    s = (n1 + n2) / 2.0
    r1 = R1[:, 0] / n1[:, None]
    r2 = R2[:, 0] / n2[:, None]
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    R = torch.stack([r1, r2, r3], dim=1)
    return s, R, t3d


def matrix_to_euler_deg(R: torch.Tensor) -> torch.Tensor:
    """Batched (B,3,3) -> (B,3) [rx, ry, rz] degrees. Gimbal lock
    (|R20| == 1) takes the reference's branch with z := 0."""
    r20 = torch.clamp(R[:, 2, 0], -1.0, 1.0)
    locked = torch.abs(torch.abs(r20) - 1.0) < 1e-7

    x = torch.asin(r20)
    y = torch.atan2(R[:, 1, 2], R[:, 2, 2])
    z = torch.atan2(R[:, 0, 1], R[:, 0, 0])

    half_pi = torch.full_like(r20, math.pi / 2)
    x_lock = torch.where(r20 < 0, half_pi, -half_pi)
    y_lock_neg = torch.atan2(R[:, 0, 1], R[:, 0, 2])      # R20 == -1
    y_lock_pos = torch.atan2(-R[:, 0, 1], -R[:, 0, 2])    # R20 == +1
    y_lock = torch.where(r20 < 0, y_lock_neg, y_lock_pos)

    x = torch.where(locked, x_lock, x)
    y = torch.where(locked, y_lock, y)
    z = torch.where(locked, torch.zeros_like(z), z)
    return torch.stack([x, y, z], dim=1) * (180.0 / math.pi)


def pose_from_param(param: torch.Tensor, pack: ParamPack
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whitened (B,62) -> (angles_deg (B,3), t3d (B,3))."""
    param_raw = dewhiten(param, pack)
    P = param_raw[:, :12].reshape(-1, 3, 4)
    _, R, t3d = p2srt(P)
    return matrix_to_euler_deg(R), t3d


def rescale_pose_to_roi(t3d: torch.Tensor, roi_box: torch.Tensor
                        ) -> torch.Tensor:
    """Translate/scale t3d (B,3) into original-image coordinates."""
    sx, sy, ex, ey = (roi_box[:, i] for i in range(4))
    scale_x = (ex - sx) / STD_SIZE
    scale_y = (ey - sy) / STD_SIZE
    return torch.stack([
        t3d[:, 0] * scale_x + sx,
        t3d[:, 1] * scale_y + sy,
        t3d[:, 2],
    ], dim=1)
