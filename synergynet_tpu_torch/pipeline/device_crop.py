"""On-device crop + bilinear resize: frames -> S x S face crops (S 120 as
SynergyNet ships, or the serving API's ``crop``, up to 512).

Counterpart of ``synergynet_tpu/pipeline/device_crop.py``. The
semantics are the host chain ``cv2.resize(crop_img(img, roi), S x S,
INTER_LINEAR)``: rois round to integers like ``crop_img``, sample
coordinates follow cv2's ``(dst + 0.5) * scale - 0.5`` rule and clamp at the
crop border, and samples from outside the image are zero.

:func:`crop_resize_bilinear` samples the four bilinear taps of each output
value: on a CUDA tensor kernel C1 (``csrc/crop_bilinear.cu``), on a CPU
tensor the plain twin :func:`crop_resize_reference`, which repeats C1's
arithmetic op for op (:func:`crop_taps` the taps, then the two rows' blend
at each column tap, then the two columns'). The JAX package's
``crop_resize_matmul`` (two products with per-roi interpolation matrices)
and ``crop_resize_hybrid`` (a row gather, then the column matmul) compute
the same function in other shapes of TPU work, for its ``crop_mode``
selector; the port has one implementation and keeps their names for it.
"""

from __future__ import annotations

import ctypes

import torch

from synergynet_tpu_torch.ops.cuda_build import (check_tensor, launch,
                                                 require_sm90)

# The largest output side C1 takes (its shared tap arrays).
C1_MAX_SIZE = 512


def square_rois(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) boxes -> square rois: side from the y-extent, margin =
    floor(side * 1.2 / 2) around the box centre."""
    hc = (boxes[..., 1] + boxes[..., 3]) / 2
    wc = (boxes[..., 0] + boxes[..., 2]) / 2
    side = boxes[..., 3] - boxes[..., 1]
    margin = torch.floor(side * 1.2 / 2)
    return torch.stack([wc - margin, hc - margin, wc + margin, hc + margin],
                       dim=-1)


def _axis_taps(start, end, size: int, out_size: int):
    """One axis of rois (...,): the source taps (..., S, 2) int64 (-1 where
    a tap lies outside [0, size)) and the second tap's weight (..., S)."""
    start = torch.round(start)
    extent = torch.round(end) - start
    # A divisor tensor: CUDA divides by a Python scalar as a reciprocal
    # multiply, which can miss the correctly rounded quotient C1 takes.
    scale = (extent / torch.full_like(extent, out_size))[..., None]
    d = torch.arange(out_size, dtype=torch.float32, device=start.device) + 0.5
    hi = torch.clamp(extent - 1.0, min=0.0)[..., None]
    c = torch.minimum(torch.clamp(d * scale - 0.5, min=0.0), hi)
    c0 = torch.floor(c)
    idx = torch.stack([c0, torch.minimum(c0 + 1.0, hi)], -1) \
        + start[..., None, None]
    inside = (idx >= 0) & (idx < size)
    return torch.where(inside, idx, -1.0).long(), c - c0


def crop_taps(rois: torch.Tensor, size_hw, out_size: int = 120):
    """Rois (..., 4) [sx, sy, ex, ey] on an image of ``size_hw`` (H, W) ->
    (idx (..., 2, S, 2) int32, f (..., 2, S) f32): per axis (rows, then
    columns) and output index the two source taps, -1 outside the image,
    and the second tap's weight. On a CUDA tensor C1's own taps
    (``synergy_crop_taps``, the function C1 samples with), on a CPU tensor
    the twin's."""
    h, w = size_hw
    if rois.device.type == "cuda":
        dev, lead, flat = rois.device, rois.shape[:-1], rois.reshape(-1, 4)
        check_tensor("rois", flat, (torch.float32,), (None, 4), dev)
        _check(dev, out_size)
        idx = torch.empty((len(flat), 2, out_size, 2), dtype=torch.int32,
                          device=dev)
        f = torch.empty((len(flat), 2, out_size), device=dev)
        launch("crop_bilinear", "synergy_crop_taps",
               [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4, dev,
               flat, idx, f, len(flat), h, w, out_size)
        return (idx.reshape(*lead, 2, out_size, 2),
                f.reshape(*lead, 2, out_size))
    ys, fy = _axis_taps(rois[..., 1], rois[..., 3], h, out_size)
    xs, fx = _axis_taps(rois[..., 0], rois[..., 2], w, out_size)
    return (torch.stack([ys, xs], -3).int(), torch.stack([fy, fx], -2))


def crop_resize_reference(image: torch.Tensor, rois: torch.Tensor,
                          out_size: int = 120) -> torch.Tensor:
    """The plain twin of C1: frames (B, H, W, C) float32 and rois (B, N, 4)
    -> (B, N, S, S, C), each value ``((1 - fy) v00 + fy v10) (1 - fx) +
    ((1 - fy) v01 + fy v11) fx`` over the taps of :func:`crop_taps`, every
    product and sum rounded once as C1 rounds it; a tap outside the image
    reads 0."""
    b, h, w, _ = image.shape
    ys, fy = _axis_taps(rois[..., 1], rois[..., 3], h, out_size)
    xs, fx = _axis_taps(rois[..., 0], rois[..., 2], w, out_size)
    fy, fx = fy[..., :, None, None], fx[..., None, :, None]
    frame = torch.arange(b, device=image.device)[:, None, None, None]

    def tap(i, j):                                       # (B, N, S, S, C)
        y, x = ys[..., i][..., :, None], xs[..., j][..., None, :]
        v = image[frame, y.clamp(min=0), x.clamp(min=0)]
        return torch.where(((y >= 0) & (x >= 0))[..., None], v, 0.0)

    gy, gx = 1.0 - fy, 1.0 - fx
    left = gy * tap(0, 0) + fy * tap(1, 0)
    right = gy * tap(0, 1) + fy * tap(1, 1)
    return gx * left + fx * right


def _check(dev: torch.device, out_size: int) -> None:
    if not 1 <= out_size <= C1_MAX_SIZE:
        raise ValueError(f"output side {out_size}: kernel C1 takes 1 to "
                         f"{C1_MAX_SIZE}")
    require_sm90(dev, "crop")


def _launch(image: torch.Tensor, rois: torch.Tensor,
            out_size: int) -> torch.Tensor:
    """Check what C1 takes, allocate its output, launch on the current
    stream. Raises on anything else; never falls back. No host read and
    no synchronisation: safe under a CUDA graph capture."""
    dev = image.device
    b, h, w, c = image.shape
    check_tensor("image", image, (torch.float32,), (None, None, None, None),
                 dev)
    check_tensor("rois", rois, (torch.float32,), (b, None, 4), dev)
    _check(dev, out_size)
    n = rois.shape[1]
    out = torch.empty((b, n, out_size, out_size, c), device=dev)
    if out.numel() == 0:
        return out
    launch("crop_bilinear", "synergy_crop_bilinear",
           [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6, dev,
           image, rois, out, b * n, n, h, w, c, out_size)
    return out


def crop_resize_bilinear(image: torch.Tensor, rois: torch.Tensor,
                         out_size: int = 120) -> torch.Tensor:
    """Frames (B, H, W, C) float32 and rois (B, N, 4) [sx, sy, ex, ey]
    pixels -> (B, N, out_size, out_size, C), every row of ``rois`` cropped.
    On a CUDA tensor kernel C1 (contiguous f32 inputs on one card, or an
    error); on a CPU tensor the plain twin :func:`crop_resize_reference`."""
    if rois.device != image.device:
        raise ValueError(f"rois on {rois.device}, frames on {image.device}")
    if image.device.type == "cuda":
        return _launch(image, rois, out_size)
    if image.device.type == "cpu":
        return crop_resize_reference(image, rois, out_size)
    raise ValueError(f"no crop for device {image.device}")


crop_resize_hybrid = crop_resize_matmul = crop_resize_bilinear
