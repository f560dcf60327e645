"""Serving API: frames -> faces -> (landmarks, dense meshes, poses).

Counterpart of ``synergynet_tpu/pipeline/api.py``'s serving path:

- :class:`SynergyNet3DMM` holds the regressor, the 3DMM pack and the
  coordinate-split dense basis on one device;
- :class:`FusedFrameEngine` runs detect (folded s2d8 FaceBoxes, anchor
  decode, top-k, greedy NMS) -> square rois -> bilinear crop -> MobileNetV2
  -> 68 landmarks + dense mesh (the ``csrc/fused_decode.cu`` kernel on a
  card) + pose, for a fixed ``max_faces`` per frame. ``process_batch`` runs
  the head batched over B frames and the decode tail once on the flat
  B x max_faces rows; ``__call__`` is the one-frame form.

The JAX package compiles all of this into one program per batch size;
here it runs eagerly on the device, and only the NMS fixpoint test and the
face count of ``__call__`` synchronise with the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from synergynet_tpu_torch.convert import synergy_state_dict
from synergynet_tpu_torch.core.checkpoint import (load_trained_variables,
                                                  shipped_trained_path)
from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.detect.anchors import decode_boxes
from synergynet_tpu_torch.detect.detector import (
    BGR_MEAN, CANVAS, CONFIDENCE_THRESHOLD, NMS_THRESHOLD, NMS_TOP_K,
    VIS_THRESHOLD, FaceBoxes, _fit_scale)
from synergynet_tpu_torch.detect.net import space_to_depth
from synergynet_tpu_torch.detect.nms import greedy_nms_mask
from synergynet_tpu_torch.mm3d.assets import ParamPack, load_param_pack
from synergynet_tpu_torch.mm3d.codec import decode_landmarks, rescale_to_roi
from synergynet_tpu_torch.mm3d.pose import (pose_from_param,
                                            rescale_pose_to_roi)
from synergynet_tpu_torch.nn.backbones.mobilenet_v2 import cast_convs_
from synergynet_tpu_torch.nn.synergy import SynergyNet
from synergynet_tpu_torch.ops.fused_decode import (build_decode_basis,
                                                   decode_dense_fused)
from synergynet_tpu_torch.pipeline.device_crop import (crop_resize_matmul,
                                                       square_rois)

CROP = 120


class SynergyNet3DMM:
    """The regressor and 3DMM constants on ``device`` (the card unless
    the caller asks for the CPU; raises when there is no card).

    ``variables``: the string ``"trained"`` (the shipped full-recipe
    weights) or a flax SynergyNet tree (converted by
    :mod:`synergynet_tpu_torch.convert`). ``dtype`` is the backbone's
    compute dtype (bf16 for serving).
    """

    def __init__(self, variables: dict | str, arch: str = "mobilenet_v2",
                 pack: Optional[ParamPack] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.device = resolve_device(device)
        if isinstance(variables, str):
            if variables != "trained":
                raise ValueError(f"unknown variables spec {variables!r} "
                                 "(only 'trained' is recognised)")
            variables = load_trained_variables(shipped_trained_path(arch))
        self.dtype = dtype
        self.pack = pack if pack is not None else load_param_pack()
        model = SynergyNet(arch=arch, dtype=dtype)
        model.load_state_dict(synergy_state_dict(variables))
        cast_convs_(model, dtype)
        self.variables = variables
        self.model = model.to(self.device).eval()
        self.basis = build_decode_basis(self.pack).to(self.device)
        # The fused decode reads the dense basis only through `basis`, so
        # the device copy of the pack drops its own dense leaves (~64 MB).
        slim = self.pack._replace(
            u=self.pack.u[:0], w_shp=self.pack.w_shp[:0],
            w_exp=self.pack.w_exp[:0])
        self.pack_dev = slim.to(self.device)


class FusedFrameEngine:
    """Frame(s) -> up to ``max_faces`` faces per frame with landmarks, dense
    mesh and pose, all on the api's device."""

    def __init__(self, api: SynergyNet3DMM,
                 detector: Optional[FaceBoxes] = None, max_faces: int = 8):
        self.api = api
        self.detector = detector or FaceBoxes(device=api.device)
        if self.detector.device != api.device:
            raise ValueError(f"detector on {self.detector.device}, api on "
                             f"{api.device}")
        self.max_faces = max_faces
        self._det_mean = torch.tensor(
            np.tile(BGR_MEAN, self.detector.stem_r ** 2), dtype=torch.float32,
            device=api.device)

    def detect_candidates(self, frames_s2d: torch.Tensor,
                          true_hws: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, CH/8, CW/8, 192) s2d frames + (B, 2) true extents ->
        (scores (B, A) with -1 at ruled-out anchors, boxes (B, A, 4) in
        canvas pixels)."""
        ch, cw = CANVAS
        det = self.detector
        loc, conf = det.net(frames_s2d - self._det_mean)
        scores = torch.softmax(conf, dim=-1)[..., 1]
        boxes = decode_boxes(loc, det.anchors) * torch.tensor(
            [cw, ch, cw, ch], dtype=torch.float32, device=loc.device)
        th = true_hws[:, 0:1].float()
        tw = true_hws[:, 1:2].float()
        cx = (boxes[..., 0] + boxes[..., 2]) / 2
        cy = (boxes[..., 1] + boxes[..., 3]) / 2
        ok = (cx < tw) & (cy < th) & (scores > CONFIDENCE_THRESHOLD)
        return torch.where(ok, scores, torch.full_like(scores, -1.0)), boxes

    def select_faces(self, scores: torch.Tensor, boxes: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Top-k, greedy NMS, visibility filter, first ``max_faces`` kept:
        (face_scores (B, F) with -1 on padding rows, n_faces (B,),
        face_boxes (B, F, 4)). Stable sorts give ``lax.top_k``'s and
        ``argsort(stable=True)``'s lower-index-first order on ties."""
        k = min(NMS_TOP_K, scores.shape[-1])
        top_scores, idx = torch.sort(scores, dim=-1, descending=True,
                                     stable=True)
        top_scores, idx = top_scores[:, :k], idx[:, :k]
        top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        keep = greedy_nms_mask(top_boxes, top_scores > 0.0, NMS_THRESHOLD)
        keep &= top_scores > VIS_THRESHOLD
        order = torch.argsort((~keep).to(torch.uint8), dim=-1,
                              stable=True)[:, :self.max_faces]
        face_boxes = torch.gather(top_boxes, 1,
                                  order[..., None].expand(-1, -1, 4))
        face_scores = torch.where(torch.gather(keep, 1, order),
                                  torch.gather(top_scores, 1, order),
                                  torch.full_like(order, -1.0,
                                                  dtype=torch.float32))
        return face_scores, (face_scores > 0).sum(-1), face_boxes

    def regress(self, frames: torch.Tensor, rois: torch.Tensor
                ) -> torch.Tensor:
        """(B, CH, CW, 3) frames + (B, F, 4) rois -> param62 (B, F, 62)."""
        b, f = rois.shape[:2]
        crops = crop_resize_matmul(frames, rois, CROP)
        xn = ((crops - 127.5) / 128.0).reshape(b * f, CROP, CROP, 3)
        param62, _ = self.api.model(xn)
        return param62.float().reshape(b, f, -1)

    def head(self, frames, frames_s2d, true_hws):
        """Detect + crop + regress for B frames -> (face_scores (B, F),
        n_faces (B,), rois (B, F, 4), param62 (B, F, 62))."""
        scores, boxes = self.detect_candidates(frames_s2d, true_hws)
        face_scores, n_faces, face_boxes = self.select_faces(scores, boxes)
        rois = square_rois(face_boxes)
        return face_scores, n_faces, rois, self.regress(frames, rois)

    def tail(self, param62: torch.Tensor, rois: torch.Tensor):
        """Flat (N, 62) params + (N, 4) rois -> (lmk (N, 3, 68), dense
        (N, 3, nver), angles (N, 3), t3d (N, 3)); row-independent."""
        pack, basis = self.api.pack_dev, self.api.basis
        lmk = rescale_to_roi(decode_landmarks(param62, pack), rois)
        dense = rescale_to_roi(decode_dense_fused(param62, basis, pack), rois)
        angles, t3d = pose_from_param(param62, pack)
        return lmk, dense, angles, rescale_pose_to_roi(t3d, rois)

    @torch.inference_mode()
    def process_batch(self, frames: torch.Tensor, frames_s2d: torch.Tensor,
                      true_hws: torch.Tensor):
        """Batched serving: (B, 720, 1088, 3) f32 frames, their s2d packing
        and (B, 2) true extents -> (face_scores, n_faces, rois, param62,
        lmk, dense, angles, t3d), each with leading dims (B, max_faces)
        (n_faces: (B,)). The decode tail runs once on the B*max_faces rows."""
        face_scores, n_faces, rois, param62 = self.head(frames, frames_s2d,
                                                        true_hws)
        b, f = rois.shape[:2]
        outs = self.tail(param62.reshape(b * f, -1), rois.reshape(b * f, -1))
        lmk, dense, angles, t3d = (x.reshape(b, f, *x.shape[1:])
                                   for x in outs)
        return (face_scores, n_faces, rois, param62, lmk, dense, angles, t3d)

    def __call__(self, img_bgr: np.ndarray) -> Tuple[List, List, List]:
        """One BGR uint8 frame -> reference-format (pts_res, vertices_lst,
        poses) in original-image coordinates, as numpy."""
        canvas, packed, true_hw, scale = prepare_frame(
            img_bgr, self.detector.stem_r, self.api.device)
        out = self.process_batch(canvas[None], packed[None], true_hw[None])
        _, n, _, _, lmk, dense, angles, t3d = (x[0].cpu().numpy()
                                               for x in out)
        return unpack_face_outputs(int(n), lmk, dense, angles, t3d, scale)


def _linear_taps(n_src: int, n_dst: int, clamp_edges: bool):
    """cv2 INTER_LINEAR's taps along one axis: (first index, second index,
    weight of the first, weight of the second), weights in 11-bit fixed
    point. The sample point is ``(d + 0.5) * scale - 0.5`` in double,
    rounded to f32; columns (``clamp_edges``) put a sample outside the
    source on the edge pixel with weight 1, rows keep the fraction and
    clamp the row index, as cv2's ``resize`` does."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
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
    top = ((rows[y0] >> 4) * b0[:, None, None]) >> 16
    bottom = ((rows[y1] >> 4) * b1[:, None, None]) >> 16
    return ((top + bottom + 2) >> 2).clamp(0, 255).float()


def prepare_frame(img_bgr: np.ndarray, stem_r: int, device="cuda"):
    """Fit a BGR uint8 frame onto the fixed detector canvas on ``device``
    (the card unless the caller asks for the CPU).

    Returns (canvas f32 (CH, CW, 3), s2d-packed canvas, true_hw int32 (2,),
    scale): frames larger than 720x1080 scale down by the reference rule
    and sit at the canvas origin on a zero border."""
    device = resolve_device(device)
    h, w = img_bgr.shape[:2]
    scale = _fit_scale(h, w)
    img = torch.from_numpy(np.ascontiguousarray(img_bgr)).to(device)
    if scale != 1.0:
        img = _resize_linear(img, int(scale * h), int(scale * w))
    hs, ws = img.shape[:2]
    ch, cw = CANVAS
    canvas = torch.zeros((ch, cw, 3), dtype=torch.float32, device=device)
    canvas[:min(hs, ch), :min(ws, cw)] = img[:ch, :cw]
    packed = space_to_depth(canvas, stem_r).contiguous()
    true_hw = torch.tensor([hs, ws], dtype=torch.int32, device=device)
    return canvas, packed, true_hw, scale


def unpack_face_outputs(n: int, lmk, dense, angles, t3d, scale: float):
    """Canvas -> original coordinates for the first ``n`` faces: x, y and z
    by 1/scale (the decode scaled z by the roi extent in canvas pixels);
    t3d z stays unscaled like the reference's predict_pose."""
    inv = 1.0 / scale
    pts, verts, poses = [], [], []
    for i in range(n):
        pts.append(lmk[i] * inv)
        verts.append(dense[i] * inv)
        t = t3d[i].copy()
        t[:2] *= inv
        poses.append([angles[i], t])
    return pts, verts, poses
