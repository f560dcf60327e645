"""The served pipeline around the networks, plainly: frame fit, anchors,
candidates, greedy NMS, square rois, the bilinear crop, the 3DMM decode and
the head pose.

Semantics are the reference repository's (``FaceBoxes`` detection with
its anchors and +1-pixel IoU, ``utils/inference.py``'s crop and
``cv2.resize`` sampling, ``utils/params.py``'s 62-parameter layout,
``utils/inference.py::predict_pose``) at the served constants: a 720x1088
canvas, scores above 0.05 inside the frame, the 2,048 best into NMS at
0.3, kept faces above 0.5.

Two sizes are apart. A face is cropped at the configuration's
``regressor.crop`` (S x S pixels, the regressor's input: 120 for the
reference's nets, other sizes for other architectures), given here as
``regressor``, the configuration's regressor entry. ``STD`` is the 3DMM's
own 120-pixel parameter space: the decode and the pose scale the
regressed camera from it to the roi, whatever the crop's size.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from perfbench.reference import regressors
from perfbench.reference.nets import faceboxes
from perfbench.reference.precision import Precision

CANVAS = (720, 1088)
MAX_H, MAX_W = 720, 1080
BGR_MEAN = (104.0, 117.0, 123.0)
CONF_T, NMS_T, VIS_T, TOP_K = 0.05, 0.3, 0.5, 2048
STEPS = (32, 64, 128)
MIN_SIZES = ((32, 64, 128), (256,), (512,))
DENSE = {32: (0.0, 0.25, 0.5, 0.75), 64: (0.0, 0.5)}
STD = 120                 # the 3DMM's parameter space, not the crop


def fit_scale(h: int, w: int) -> float:
    """The reference's downscale onto the canvas: h <= 720, then w <=
    1080, never up."""
    scale = 1.0
    if h > MAX_H:
        scale = MAX_H / h
    if w * scale > MAX_W:
        scale *= MAX_W / (w * scale)
    return scale


def resize_linear(img: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """OpenCV's ``cv2.resize(INTER_LINEAR)`` of an (H, W, C) uint8 image,
    in its fixed-point arithmetic (``resize.cpp``: 11-bit weights, a
    horizontal pass of integer sums, the vertical pass
    ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16)`` rounded by
    ``(+ 2) >> 2``, saturated) -> float levels."""
    def taps(n_in, n_out, edge):
        scale = 1.0 / (n_out / n_in)
        f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
        i = np.floor(f).astype(np.int64)
        f = f - i.astype(np.float32)
        if edge:                      # columns: outside samples take the edge
            out = (i < 0) | (i >= n_in - 1)
            f[out] = 0.0
            i = np.clip(i, 0, n_in - 1)
        w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
        w1 = np.rint(f * np.float32(2048)).astype(np.int32)
        return [torch.from_numpy(a).to(img.device) for a in
                (np.clip(i, 0, n_in - 1), np.clip(i + 1, 0, n_in - 1), w0,
                 w1)]

    x0, x1, a0, a1 = taps(img.shape[1], ow, True)
    y0, y1, b0, b1 = taps(img.shape[0], oh, False)
    src = img.int()
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    s0, s1 = rows[y0], rows[y1]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    return (((((s0 >> 4) * b0) >> 16) + (((s1 >> 4) * b1) >> 16) + 2)
            >> 2).clamp(0, 255).float()


def fit_frame(img_u8: np.ndarray, device) -> Tuple[torch.Tensor, tuple,
                                                      float]:
    """A BGR uint8 frame -> (float canvas (720, 1088, 3), true (h, w),
    scale): scaled down by :func:`fit_scale`, at the canvas origin on
    zeros."""
    h, w = img_u8.shape[:2]
    scale = fit_scale(h, w)
    img = torch.from_numpy(np.ascontiguousarray(img_u8)).to(device)
    img = resize_linear(img, int(scale * h), int(scale * w)) \
        if scale != 1.0 else img.float()
    canvas = torch.zeros(CANVAS + (3,), device=device)
    hs, ws = min(img.shape[0], CANVAS[0]), min(img.shape[1], CANVAS[1])
    canvas[:hs, :ws] = img[:hs, :ws]
    return canvas, (hs, ws), scale


def anchors(h: int, w: int, device) -> torch.Tensor:
    """(A, 4) [cx, cy, w, h] normalized, in the heads' order."""
    out = []
    for step, sizes in zip(STEPS, MIN_SIZES):
        fh, fw = math.ceil(h / step), math.ceil(w / step)
        for i in range(fh):
            for j in range(fw):
                for ms in sizes:
                    for oy in DENSE.get(ms, (0.5,)):
                        for ox in DENSE.get(ms, (0.5,)):
                            out.append(((j + ox) * step / w,
                                        (i + oy) * step / h, ms / w, ms / h))
    return torch.tensor(out, dtype=torch.float32, device=device)


def candidates(p: Precision, det: dict, canvas: torch.Tensor,
               true_hw: torch.Tensor, anc: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """(B, 720, 1088, 3) canvases -> per anchor the logit (conf1 - conf0),
    the score, the box in canvas pixels and ``valid`` (score above 0.05,
    centre inside the true frame)."""
    mean = torch.tensor(BGR_MEAN, device=canvas.device)
    loc, conf = faceboxes(p, det, canvas - mean)
    h, w = canvas.shape[1:3]
    centre = anc[:, :2] + loc[..., :2] * 0.1 * anc[:, 2:]
    wh = anc[:, 2:] * torch.exp(loc[..., 2:] * 0.2)
    tl = centre - wh / 2
    boxes = torch.cat([tl, tl + wh], -1) * torch.tensor(
        [w, h, w, h], dtype=torch.float32, device=canvas.device)
    score = torch.softmax(conf, -1)[..., 1]
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    th = true_hw[:, 0:1].float()
    tw = true_hw[:, 1:2].float()
    valid = (cx < tw) & (cy < th) & (score > CONF_T)
    return {"logit": conf[..., 1] - conf[..., 0], "score": score,
            "boxes": boxes, "valid": valid}


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) x (..., N, 4) -> (..., M, N), +1-pixel areas."""
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + 1).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def top_candidates(c: Dict[str, torch.Tensor], k: int = TOP_K):
    """The ``k`` best by score (stable: lower index first on ties) ->
    (order (B, k), their boxes, their valid flags)."""
    s = torch.where(c["valid"], c["score"], torch.full_like(c["score"], -1))
    s, order = torch.sort(s, dim=-1, descending=True, stable=True)
    order = order[:, :k]
    boxes = torch.gather(c["boxes"], 1, order[..., None].expand(-1, -1, 4))
    return order, boxes, s[:, :k] > 0


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor,
                thr: float = NMS_T) -> torch.Tensor:
    """Greedy NMS over score-sorted (B, K, 4) boxes: a box is kept unless
    a kept box before it has IoU >= ``thr`` with it."""
    b, k = valid.shape
    keep = torch.zeros_like(valid)
    sup = torch.zeros_like(valid)
    for f0 in range(0, b, 32):
        sl = slice(f0, f0 + 32)
        ov = iou(boxes[sl], boxes[sl]) >= thr
        for i in range(k):
            ki = valid[sl, i] & ~sup[sl, i]
            keep[sl, i] = ki
            sup[sl] |= ki[:, None] & ov[:, i]
    return keep


def square_rois(boxes: torch.Tensor) -> torch.Tensor:
    """The reference's ``parse_roi_box_from_bbox``: a square of side
    2 * floor(1.2 * height / 2) about the box centre."""
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    m = torch.floor((boxes[..., 3] - boxes[..., 1]) * 1.2 / 2)
    return torch.stack([cx - m, cy - m, cx + m, cy + m], -1)


def crop(canvas: torch.Tensor, rois: torch.Tensor, size: int
         ) -> torch.Tensor:
    """``cv2.resize(crop_img(img, roi), (size, size), INTER_LINEAR)`` as a
    four-tap gather: (H, W, 3) canvas, (N, 4) rois -> (N, size, size, 3).
    Rois round to whole pixels; samples outside the image are zero."""
    h, w = canvas.shape[:2]
    r = torch.round(rois)
    d = torch.arange(size, dtype=torch.float32, device=canvas.device) + 0.5

    def taps(start, extent, limit):
        hi = (extent - 1).clamp(min=0)[:, None]
        c = torch.minimum((d * (extent / size)[:, None] - 0.5).clamp(min=0),
                          hi)
        c0 = torch.floor(c)
        i0 = (c0 + start[:, None]).long()
        i1 = (torch.minimum(c0 + 1, hi) + start[:, None]).long()
        f = c - c0
        ok0 = (i0 >= 0) & (i0 < limit)
        ok1 = (i1 >= 0) & (i1 < limit)
        return (i0.clamp(0, limit - 1), i1.clamp(0, limit - 1),
                (1 - f) * ok0, f * ok1)

    y0, y1, wy0, wy1 = taps(r[:, 1], r[:, 3] - r[:, 1], h)
    x0, x1, wx0, wx1 = taps(r[:, 0], r[:, 2] - r[:, 0], w)
    out = 0
    for yi, wy in ((y0, wy0), (y1, wy1)):
        for xi, wx in ((x0, wx0), (x1, wx1)):
            px = canvas[yi[:, :, None], xi[:, None, :]]      # (N, S, S, 3)
            out = out + px * (wy[:, :, None] * wx[:, None, :])[..., None]
    return out


def regress(p: Precision, regressor: dict, reg: dict,
            canvases: torch.Tensor, rois: torch.Tensor, chunk: int = 512
            ) -> torch.Tensor:
    """(B, H, W, 3) canvases + (B, N, 4) rois -> (B, N, 62) whitened
    parameters: crops at ``regressor["crop"]`` through the reference net
    of ``regressor["arch"]`` with the tree ``reg``."""
    net = regressors.load(regressor["arch"]).forward
    b, n = rois.shape[:2]
    x = torch.cat([crop(canvases[f], rois[f], regressor["crop"])
                   for f in range(b)])
    out = [net(p, reg, (x[i:i + chunk] - 127.5) / 128.0)
           for i in range(0, b * n, chunk)]
    return torch.cat(out or [x.new_zeros((0, 62))]).reshape(b, n, 62)


def decode(p: Precision, pack: Dict[str, torch.Tensor], param: torch.Tensor,
           rois: torch.Tensor, dense: bool = True):
    """Whitened (N, 62) + (N, 4) rois -> (lmk (N, 3, 68), dense (N, 3, V)
    or None, angles (N, 3) degrees, t3d (N, 3)) in canvas pixels."""
    raw = param * pack["param_std"] + pack["param_mean"]
    cam = raw[:, :12].reshape(-1, 3, 4)
    alpha = raw[:, 12:62]
    sx, sy, ex, ey = rois.unbind(-1)
    scale = torch.stack([(ex - sx) / STD, (ey - sy) / STD,
                         ((ex - sx) / STD + (ey - sy) / STD) / 2], -1)
    shift = torch.stack([sx, sy, torch.zeros_like(sx)], -1)

    def verts(u, basis):
        flat = u[None] + p.matmul(alpha, basis.T)            # (N, 3V)
        base = flat.reshape(flat.shape[0], -1, 3).transpose(1, 2)
        v = p.matmul(cam[:, :, :3], base) + cam[:, :, 3:]
        v[:, 1] = STD + 1 - v[:, 1]
        return v * scale[:, :, None] + shift[:, :, None]

    kp = pack["keypoints"]
    lmk = verts(pack["u"][kp], pack["w"][kp])
    mesh = verts(pack["u"], pack["w"]) if dense else None
    return (lmk, mesh, *pose(p, cam, rois))


def pose(p: Precision, cam: torch.Tensor, rois: torch.Tensor):
    """The reference's ``P2sRt`` + ``matrix2angle_corr`` -> (angles in
    degrees [x, y, z], t3d in canvas pixels)."""
    r1 = cam[:, 0, :3] / torch.linalg.norm(p.q(cam[:, 0, :3]), dim=-1,
                                           keepdim=True)
    r2 = cam[:, 1, :3] / torch.linalg.norm(p.q(cam[:, 1, :3]), dim=-1,
                                           keepdim=True)
    r3 = torch.linalg.cross(p.q(r1), p.q(r2), dim=-1)
    rot = torch.stack([r1, r2, r3], 1)
    r20 = rot[:, 2, 0].clamp(-1, 1)
    x = torch.asin(r20)
    y = torch.atan2(rot[:, 1, 2], rot[:, 2, 2])
    z = torch.atan2(rot[:, 0, 1], rot[:, 0, 0])
    lock = (r20.abs() - 1).abs() < 1e-7
    x = torch.where(lock, torch.where(r20 < 0, math.pi / 2, -math.pi / 2), x)
    y = torch.where(lock, torch.where(
        r20 < 0, torch.atan2(rot[:, 0, 1], rot[:, 0, 2]),
        torch.atan2(-rot[:, 0, 1], -rot[:, 0, 2])), y)
    z = torch.where(lock, torch.zeros_like(z), z)
    t = cam[:, :, 3]
    sx, sy, ex, ey = rois.unbind(-1)
    t3d = torch.stack([t[:, 0] * (ex - sx) / STD + sx,
                       t[:, 1] * (ey - sy) / STD + sy, t[:, 2]], -1)
    return torch.stack([x, y, z], -1) * (180 / math.pi), t3d


def pack_tensors(arrays: Dict[str, np.ndarray], device) -> Dict:
    """The 3DMM asset arrays -> the reference's pack: the interleaved mean
    ``u`` (3V,), the basis ``w`` (3V, 50), the 204 keypoint rows, the
    (T, 3) triangles."""
    u = (arrays["u_shp"] + arrays["u_exp"]).reshape(-1)
    w = np.concatenate([arrays["w_shp"], arrays["w_exp"]], 1)
    return {"u": torch.tensor(u, device=device),
            "w": torch.tensor(w, device=device),
            "keypoints": torch.tensor(arrays["keypoints"].astype(np.int64),
                                      device=device),
            "param_mean": torch.tensor(arrays["param_mean"][:62],
                                       device=device),
            "param_std": torch.tensor(arrays["param_std"][:62],
                                      device=device),
            "tri": torch.tensor(arrays["tri"].T.astype(np.int64),
                                device=device).contiguous()}


def serve(p: Precision, regressor: dict, det: dict, reg: dict, pack: dict,
          canvas: torch.Tensor, true_hw: torch.Tensor, max_faces: int,
          anc: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The whole pipeline on (B, 720, 1088, 3) canvases, the served
    outputs' layout (faces per frame padded to ``max_faces``, ``n`` the
    real ones): what the control puts in the program's place."""
    c = candidates(p, det, canvas, true_hw, anc)
    order, boxes, valid = top_candidates(c)
    s = torch.gather(c["score"], 1, order)
    keep = greedy_keep(boxes, valid) & (s > VIS_T)
    pick = torch.argsort((~keep).to(torch.uint8), dim=-1,
                         stable=True)[:, :max_faces]
    n = keep.sum(-1).clamp(max=max_faces)
    rois = square_rois(torch.gather(boxes, 1,
                                    pick[..., None].expand(-1, -1, 4)))
    b, f = rois.shape[:2]
    param = regress(p, regressor, reg, canvas, rois)
    lmk, dense, angles, t3d = decode(p, pack, param.reshape(-1, 62),
                                     rois.reshape(-1, 4))
    return {"n": n, "rois": rois, "param": param,
            "lmk": lmk.reshape(b, f, 3, -1),
            "dense": dense.reshape(b, f, 3, -1),
            "angles": angles.reshape(b, f, 3), "t3d": t3d.reshape(b, f, 3)}
