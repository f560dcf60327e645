"""On-device crop + bilinear resize: frames -> fixed 120x120 face crops.

Counterpart of ``synergynet_tpu/pipeline/device_crop.py``. The
semantics are the host chain ``cv2.resize(crop_img(img, roi), 120x120,
INTER_LINEAR)``: rois round to integers like ``crop_img``, sample
coordinates follow cv2's ``(dst + 0.5) * scale - 0.5`` rule and clamp at the
crop border, and samples from outside the image are zero. Resampling is
separable, so each crop is two products with per-roi interpolation
matrices, as in the JAX package; the products stay ``torch.matmul``.

The JAX package's ``crop_resize_bilinear`` (a four-tap gather) and
``crop_resize_hybrid`` (a row gather, then the column matmul) compute the
same function in other shapes of TPU work, for its ``crop_mode`` selector;
the port has one implementation and keeps their names for it.
"""

from __future__ import annotations

import torch

from synergynet_tpu_torch.mm3d.codec import full_fp32


def square_rois(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) boxes -> square rois: side from the y-extent, margin =
    floor(side * 1.2 / 2) around the box centre."""
    hc = (boxes[..., 1] + boxes[..., 3]) / 2
    wc = (boxes[..., 0] + boxes[..., 2]) / 2
    side = boxes[..., 3] - boxes[..., 1]
    margin = torch.floor(side * 1.2 / 2)
    return torch.stack([wc - margin, hc - margin, wc + margin, hc + margin],
                       dim=-1)


def _interp_matrix(start, extent, size: int, out_size: int) -> torch.Tensor:
    """(..., out_size, size) row-interpolation operator: out = M @ axis.
    Out-of-image coordinates match no column, giving the zero pad."""
    d = torch.arange(out_size, dtype=torch.float32, device=start.device) + 0.5
    hi = torch.clamp(extent - 1.0, min=0.0)[..., None]
    c = torch.minimum(torch.clamp(d * (extent / out_size)[..., None] - 0.5,
                                  min=0.0), hi)
    c0 = torch.floor(c)
    f = c - c0
    idx0 = c0 + start[..., None]
    idx1 = torch.minimum(c0 + 1.0, hi) + start[..., None]
    grid = torch.arange(size, dtype=torch.float32, device=start.device)
    return ((grid == idx0[..., None]) * (1.0 - f)[..., None]
            + (grid == idx1[..., None]) * f[..., None])


def crop_resize_matmul(image: torch.Tensor, rois: torch.Tensor,
                       out_size: int = 120) -> torch.Tensor:
    """Frames (B, H, W, C) float and rois (B, N, 4) [sx, sy, ex, ey]
    pixels -> (B, N, out_size, out_size, C)."""
    b, h, w, c = image.shape
    n = rois.shape[1]
    sx = torch.round(rois[..., 0])
    sy = torch.round(rois[..., 1])
    cw = torch.round(rois[..., 2]) - sx
    chh = torch.round(rois[..., 3]) - sy
    my = _interp_matrix(sy, chh, h, out_size)            # (B, N, S, H)
    mx = _interp_matrix(sx, cw, w, out_size)             # (B, N, S, W)
    with full_fp32():
        rows = torch.bmm(my.reshape(b, n * out_size, h),
                         image.reshape(b, h, w * c))     # (B, N*S, W*C)
        rows = rows.reshape(b * n, out_size, w, c).transpose(1, 2).reshape(
            b * n, w, out_size * c)                      # (BN, W, Srow*C)
        cols = torch.bmm(mx.reshape(b * n, out_size, w),
                         rows)                           # (BN, Scol, Srow*C)
    cols = cols.reshape(b, n, out_size, out_size, c)     # (.., Scol, Srow, C)
    return cols.transpose(2, 3).contiguous()             # (.., Srow, Scol, C)


crop_resize_bilinear = crop_resize_hybrid = crop_resize_matmul
