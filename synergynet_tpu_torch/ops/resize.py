"""``cv2.resize`` on 8-bit images, bit for bit, as device tensor ops.

The JAX package resizes on the host with OpenCV: the detector's canvas fit
(``INTER_LINEAR``) and the packaged API's face crops (``INTER_LANCZOS4`` by
default, ``INTER_LINEAR`` in the demo script). The card's machine has no
OpenCV, so the port emulates OpenCV's fixed-point resampling of uint8
images:

- **INTER_LINEAR** (:func:`_resize_linear`): 11-bit weights, a horizontal
  pass of int32 sums, then the vertical vector pass
  ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16)``, ``(+ 2) >> 2``,
  saturated. At an exact 2x downscale OpenCV takes its area path, whose
  result this equals.
- **INTER_LANCZOS4** (:func:`_lanczos4_taps`): per axis, the sample point
  ``fx = float((d + 0.5) * scale - 0.5)`` in float32 (with float64 sample
  points about 1% of the values come out one level off), ``sx = floor(fx)``,
  ``fx -= sx``; OpenCV's ``interpolateLanczos4(fx)`` in float32 (the unit
  tap where ``fx`` is 0); each coefficient rounded to an int at x2048,
  NOT renormalised (a row of taps sums to 2045-2051); taps ``sx-3 .. sx+4``
  clamped to the source's ``[0, n-1]``; a horizontal then a vertical int32
  sum, ``(+ 2^21) >> 22``, saturated to [0, 255].

:func:`crop_resize_cv2` crops and resizes many faces of one frame in one
batched gather: each face's crop is the zero-padded ``crop_img`` of its
integer roi, and its taps clamp to the crop's own extent (border
replicate of the zero-padded crop, not of the frame), so a tap that lands
outside the frame reads 0.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

_COEF_SCALE = 2048                     # INTER_RESIZE_COEF_SCALE (11 bits)
_S45 = 0.70710678118654752440084436210485
# OpenCV's interpolateLanczos4 table: (cos, sin) phase of each tap.
_LANCZOS_CS = np.asarray([(1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45),
                          (-1, 0), (_S45, _S45), (0, -1), (-_S45, _S45)])
# Faces per chunk of crop_resize_cv2's gather: ~11 MB of int32 taps a face
# for LANCZOS4.
_FACE_CHUNK = 4
INTERPOLATIONS = ("lanczos4", "linear")


def _sample_points(n_src: int, n_dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's source positions along one axis: (sx int64, fx float32)
    with ``fx = float((d + 0.5) * scale - 0.5) - sx``; the scale is
    ``1 / (n_dst / n_src)`` in double, as ``cv::resize`` computes it."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s.astype(np.float32)


def _linear_taps(n_src: int, n_dst: int, clamp_edges: bool):
    """cv2 INTER_LINEAR's taps along one axis: (first index, second index,
    weight of the first, weight of the second), weights in 11-bit fixed
    point. Columns (``clamp_edges``) put a sample outside the source on the
    edge pixel with weight 1, rows keep the fraction and clamp the row
    index, as cv2's ``resize`` does."""
    s, f = _sample_points(n_src, n_dst)
    if clamp_edges:
        edge = (s < 0) | (s >= n_src - 1)
        f[edge] = 0.0
        s = np.where(s < 0, 0, np.where(s >= n_src - 1, n_src - 1, s))
    w0 = np.rint((np.float32(1.0) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return (np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1), w0, w1)


def _resize_linear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W, C) uint8 -> (h, w, C) float of uint8 values, equal bit for
    bit to ``cv2.resize(img, (w, h))`` (INTER_LINEAR on 8-bit images): a
    horizontal pass of int32 sums of 11-bit weights, then cv2's vertical
    vector pass, ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16)``
    rounded by ``(+ 2) >> 2`` and saturated to [0, 255]."""
    dev = img.device
    x0, x1, a0, a1 = (torch.from_numpy(t).to(dev)
                      for t in _linear_taps(img.shape[1], w, True))
    y0, y1, b0, b1 = (torch.from_numpy(t).to(dev)
                      for t in _linear_taps(img.shape[0], h, False))
    src = img.int()
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    return _linear_vertical(rows[y0], rows[y1], b0[:, None, None],
                            b1[:, None, None]).float()


def _linear_vertical(s0, s1, b0, b1) -> torch.Tensor:
    """cv2's INTER_LINEAR vertical pass over int32 row sums -> int32 in
    [0, 255]."""
    return (((((s0 >> 4) * b0) >> 16) + (((s1 >> 4) * b1) >> 16) + 2)
            >> 2).clamp(0, 255)


def lanczos4_coefficients(fx: np.ndarray) -> np.ndarray:
    """OpenCV's ``interpolateLanczos4`` for float32 ``fx`` (n,) in [0, 1) ->
    (n, 8) float32: each tap ``(cs0 sin(y0) + cs1 cos(y0)) / y^2`` with
    ``y0 = -(fx + 3) pi / 4`` and ``y = -(fx + 3 - i) pi / 4`` in double,
    rounded to float, summed in float in tap order, and scaled by the
    float reciprocal of the sum; a tap whose ``fx + 3 - i`` is within 1e-6
    of 0 takes 1e30 first, so ``fx == 0`` gives the unit tap."""
    fx = np.asarray(fx, np.float32)
    x3 = fx + np.float32(3)
    y0 = -x3.astype(np.float64) * math.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    coef = np.empty(fx.shape + (8,), np.float32)
    total = np.zeros(fx.shape, np.float32)
    for i in range(8):
        d = x3 - np.float32(i)
        y = -d.astype(np.float64) * math.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            v = ((_LANCZOS_CS[i, 0] * s0 + _LANCZOS_CS[i, 1] * c0)
                 / (y * y)).astype(np.float32)
        coef[..., i] = np.where(np.abs(d) >= np.float32(1e-6), v,
                                np.float32(1e30))
        total = total + coef[..., i]
    return coef * (np.float32(1.0) / total)[..., None]


def _lanczos4_taps(n_src: int, n_dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """INTER_LANCZOS4's taps along one axis: (source index (n_dst, 8) int64
    clamped to [0, n_src - 1], weight (n_dst, 8) int32 at x2048)."""
    s, f = _sample_points(n_src, n_dst)
    w = np.rint(lanczos4_coefficients(f) * np.float32(_COEF_SCALE))
    idx = np.clip(s[:, None] + np.arange(-3, 5)[None, :], 0, n_src - 1)
    return idx, w.astype(np.int32)


def _axis_taps(start: int, n_src: int, n_frame: int, n_dst: int,
               interpolation: str, columns: bool):
    """One face's taps along one axis of the frame: (frame index (n_dst, K)
    int64, -1 where the crop's pixel lies outside the frame, weights
    (n_dst, K) int32)."""
    if interpolation == "lanczos4":
        idx, wt = _lanczos4_taps(n_src, n_dst)
    else:
        i0, i1, w0, w1 = _linear_taps(n_src, n_dst, columns)
        idx, wt = np.stack([i0, i1], 1), np.stack([w0, w1], 1)
    idx = idx + start
    return np.where((idx >= 0) & (idx < n_frame), idx, -1), wt


def crop_resize_cv2(frame: torch.Tensor,
                    rects: Sequence[Tuple[int, int, int, int]],
                    size: int = 120, interpolation: str = "lanczos4"
                    ) -> torch.Tensor:
    """(H, W, C) uint8 frame on any device + N integer crops (sx, sy, ex,
    ey) -> (N, size, size, C) uint8 on the frame's device, equal bit for bit
    to ``cv2.resize(crop_img(frame, rect), (size, size), interpolation=...)``
    for ``"lanczos4"`` (INTER_LANCZOS4) and ``"linear"`` (INTER_LINEAR). An
    empty crop (``ex <= sx`` or ``ey <= sy``, from a degenerate detection)
    gives a zero crop, where ``cv2.resize`` raises.

    The tap tables are built on the host (numpy, per face and axis); the
    pixels are read with one gather per chunk of faces from the flat frame
    with a zero pixel appended, which every tap outside the frame reads.
    LANCZOS4 sums the int32 products over all 8 x 8 taps: the horizontal
    sums lie in [-255 N, 255 P] and the vertical sum in
    [-255 (P N + N P), 255 (P^2 + N^2)], where P = 2780 and N = 732 are the
    largest positive and negative tap sums of a row over every ``fx``, so
    its magnitude stays below 255 (P^2 + N^2) = 2,107,377,120 < 2^31 - 1
    for any uint8 input -- but only just. The taps depend on ``fx`` alone,
    so the bound holds at every output ``size``."""
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"interpolation {interpolation!r} not in "
                         f"{INTERPOLATIONS}")
    if frame.dtype != torch.uint8 or frame.dim() != 3:
        raise ValueError(f"expected an (H, W, C) uint8 frame, got "
                         f"{frame.dtype} {tuple(frame.shape)}")
    h, w, c = frame.shape
    dev = frame.device
    out = torch.zeros((len(rects), size, size, c), dtype=torch.uint8,
                      device=dev)
    faces = [i for i, (sx, sy, ex, ey) in enumerate(rects)
             if ex > sx and ey > sy]
    if not faces:
        return out
    flat = torch.cat([frame.reshape(h * w, c).int(),
                      torch.zeros((1, c), dtype=torch.int32, device=dev)])
    for n0 in range(0, len(faces), _FACE_CHUNK):
        chunk = faces[n0:n0 + _FACE_CHUNK]
        ys, xs = [], []
        for i in chunk:
            sx, sy, ex, ey = rects[i]
            ys.append(_axis_taps(sy, ey - sy, h, size, interpolation, False))
            xs.append(_axis_taps(sx, ex - sx, w, size, interpolation, True))
        yi, yw, xi, xw = (torch.from_numpy(np.stack(a)).to(dev) for a in (
            [t[0] for t in ys], [t[1] for t in ys], [t[0] for t in xs],
            [t[1] for t in xs]))
        # (n, size, Ky, 1, 1) x (n, 1, 1, size, Kx) -> flat pixel ids
        ok = (yi >= 0)[:, :, :, None, None] & (xi >= 0)[:, None, None]
        pix = yi[:, :, :, None, None] * w + xi[:, None, None]
        pix = torch.where(ok, pix, torch.full_like(pix, h * w))
        taps = flat[pix]                          # (n, S, Ky, S, Kx, C)
        rows = (taps * xw[:, None, None, :, :, None]).sum(
            4, dtype=torch.int32)                 # (n, S, Ky, S, C)
        if interpolation == "lanczos4":
            acc = (rows * yw[:, :, :, None, None]).sum(2, dtype=torch.int32)
            res = ((acc + (1 << 21)) >> 22).clamp(0, 255)
        else:
            b = yw[:, :, :, None, None]
            res = _linear_vertical(rows[:, :, 0], rows[:, :, 1], b[:, :, 0],
                                   b[:, :, 1])
        out[chunk] = res.to(torch.uint8)
    return out
