"""Serving API: frames -> faces -> (landmarks, dense meshes, poses).

Counterpart of ``synergynet_tpu/pipeline/api.py``:

- :class:`SynergyNet3DMM` holds the regressor, the 3DMM pack and the
  coordinate-split dense basis on one device, and is the packaged
  two-stage API of the reference (``synergy3DMM.SynergyNet.get_all_outputs``,
  reference synergy3DMM.py:167-207): ``get_all_outputs`` squares each rect
  on the host, crops and resizes every face on the device with
  :func:`preprocess_crops`' ``cv2.resize`` emulation (LANCZOS4 by default,
  bit for bit), and ``process_crops`` runs the regressor (any backbone
  family; MobileNetV2 is the shipped one) -> 62 parameters -> 68
  landmarks + dense mesh (the ``csrc/fused_decode.cu`` kernel on a card)
  + pose, in chunks of ``MAX_FACES_PER_BATCH`` faces. The JAX package pads
  the chunks to power-of-two buckets to bound its compiles; the port runs
  each chunk at its own size, and no output depends on the chunking;
- :class:`FusedFrameEngine` runs detect (FaceBoxes, anchor decode,
  top-k, greedy NMS) -> square rois -> bilinear crop -> the api's
  regressor -> 68 landmarks + dense mesh + pose, for a fixed
  ``max_faces`` per frame.
  ``process_batch`` runs the head batched over B frames and the decode tail
  once on the flat B x max_faces rows; ``__call__`` is the one-frame form.

The JAX package compiles each of these into one program; here they run
eagerly on the device, and only the NMS fixpoint test and the face counts
synchronise with the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from synergynet_tpu_torch.convert import synergy_state_dict
from synergynet_tpu_torch.core.checkpoint import load_shipped_trained
from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.detect.detector import (FaceBoxes, prepare_frame,
                                                  rank_and_keep)
from synergynet_tpu_torch.mm3d.assets import N_LMK, ParamPack, load_param_pack
from synergynet_tpu_torch.mm3d.codec import (decode_landmarks, full_fp32,
                                             full_fp32_if, rescale_to_roi)
from synergynet_tpu_torch.mm3d.crop import crop_rect, square_box
from synergynet_tpu_torch.mm3d.pose import (pose_from_param,
                                            rescale_pose_to_roi)
from synergynet_tpu_torch.nn.layers import cast_convs_
from synergynet_tpu_torch.nn.synergy import (SynergyNet,
                                             init_synergy_variables)
from synergynet_tpu_torch.ops.fused_decode import (build_decode_basis,
                                                   decode_dense_fused)
from synergynet_tpu_torch.ops.resize import crop_resize_cv2
from synergynet_tpu_torch.pipeline.device_crop import (crop_resize_matmul,
                                                       square_rois)

CROP = 120
MAX_FACES_PER_BATCH = 16


def _crops_on(frame: torch.Tensor, roi_boxes: Sequence,
              interpolation: str) -> torch.Tensor:
    """(H, W, 3) uint8 frame on its device + N roi boxes -> (N, 120, 120, 3)
    uint8 on that device."""
    return crop_resize_cv2(frame, [crop_rect(rb) for rb in roi_boxes], CROP,
                           interpolation)


def preprocess_crops(img_bgr: np.ndarray, roi_boxes: Sequence[np.ndarray],
                     interpolation: str = "lanczos4", device="cuda"
                     ) -> np.ndarray:
    """Crop + resize every roi to a (N, 120, 120, 3) uint8 stack, equal bit
    for bit to the JAX package's ``cv2.resize(crop_img(img, roi), (120,
    120), interpolation=...)``: ``'lanczos4'`` (packaged API,
    synergy3DMM.py:188) or ``'linear'`` (demo script, singleImage.py:77 --
    quirk Q7). The frame is uploaded once and every face resampled in one
    batched gather on ``device`` (the card unless the caller asks for the
    CPU)."""
    frame = torch.from_numpy(np.ascontiguousarray(img_bgr, np.uint8)).to(
        resolve_device(device))
    return _crops_on(frame, roi_boxes, interpolation).cpu().numpy()


class SynergyNet3DMM:
    """The regressor and 3DMM constants on ``device`` (the card unless
    the caller asks for the CPU; raises when there is no card). Construct
    once; call :meth:`get_all_outputs` per image. The parameters bind
    positionally as the JAX class's, ``(arch, variables, pack, detector,
    dtype, seed)``, with ``device`` after them.

    ``variables``: the string ``"trained"`` (the shipped full-recipe
    weights, ``arch="mobilenet_v2"`` only, as in the JAX package), a flax
    SynergyNet tree of ``arch`` (any name of
    :func:`~synergynet_tpu_torch.nn.available_backbones`; from training,
    a checkpoint or a reference ``best.pth.tar`` through
    :func:`synergynet_tpu_torch.nn.torch_import.load_synergynet_variables`,
    converted by :mod:`synergynet_tpu_torch.convert`), or ``None``: flax's
    init drawn from ``torch.Generator().manual_seed(seed)``, so the
    pipeline runs without a checkpoint. ``dtype`` is the backbone's compute
    dtype (bf16 for serving). :meth:`process_crops` and :meth:`get_all_outputs` run
    their f32 products and convolutions in full f32, TF32 off, as the JAX
    package's API computes by default. ``detector``: the
    :class:`FaceBoxes` that :meth:`get_all_outputs` calls when given no
    rects; built on first use on the same device when not given.
    """

    def __init__(self, arch: str = "mobilenet_v2",
                 variables: dict | str | None = None,
                 pack: Optional[ParamPack] = None,
                 detector: Optional[FaceBoxes] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        if isinstance(variables, str):
            if variables != "trained":
                raise ValueError(f"unknown variables spec {variables!r} "
                                 "(only 'trained' is recognised)")
            variables = load_shipped_trained(arch)
        self.dtype = dtype
        self.pack = pack if pack is not None else load_param_pack()
        model = SynergyNet(arch=arch, dtype=dtype)
        if variables is None:
            variables = init_synergy_variables(
                model, torch.Generator().manual_seed(seed))
        else:
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
        self._detector = detector

    @property
    def detector(self) -> FaceBoxes:
        if self._detector is None:
            self._detector = FaceBoxes(device=self.device)
        return self._detector

    def decode(self, param62: torch.Tensor, rois: torch.Tensor):
        """(N, 62) params + (N, 4+) rois -> (lmk (N, 3, 68), dense
        (N, 3, nver), angles (N, 3), t3d (N, 3)) in the rois' image
        coordinates; row-independent."""
        pack = self.pack_dev
        lmk = rescale_to_roi(decode_landmarks(param62, pack), rois)
        dense = rescale_to_roi(decode_dense_fused(param62, self.basis, pack),
                               rois)
        angles, t3d = pose_from_param(param62, pack)
        return lmk, dense, angles, rescale_pose_to_roi(t3d, rois)

    @torch.inference_mode()
    def _process(self, crops: torch.Tensor, rois: torch.Tensor):
        """(N, 120, 120, 3) uint8 crops + (N, 4) f32 rois on the device ->
        (param62, lmk, dense, angles, t3d) tensors, run in chunks of
        ``MAX_FACES_PER_BATCH`` faces, TF32 off."""
        out = []
        with full_fp32():
            for start in range(0, crops.shape[0], MAX_FACES_PER_BATCH):
                c = crops[start:start + MAX_FACES_PER_BATCH]
                r = rois[start:start + MAX_FACES_PER_BATCH]
                param62, _ = self.model((c.float() - 127.5) / 128.0)
                param62 = param62.float()
                out.append((param62, *self.decode(param62, r)))
        return [torch.cat(parts) for parts in zip(*out)]

    def process_crops(self, crops_u8, roi_boxes):
        """Batched core: (N, 120, 120, 3) uint8 crops (numpy or a tensor) +
        (N, 4+) roi boxes -> (param62, lmk, dense, angles, t3d) numpy arrays
        with leading dim N, in the rois' image coordinates. At zero faces
        the five arrays are empty with the contract's trailing shapes."""
        n = len(crops_u8)
        if n == 0:
            return (np.zeros((0, 62), np.float32),
                    np.zeros((0, 3, N_LMK), np.float32),
                    np.zeros((0, 3, self.pack.nver), np.float32),
                    np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.float32))
        crops = torch.as_tensor(crops_u8).to(self.device)
        rois = torch.as_tensor(np.asarray(roi_boxes, np.float32)[:, :4],
                               device=self.device)
        return [x.cpu().numpy() for x in self._process(crops, rois)]

    def get_all_outputs(self, img_bgr: np.ndarray,
                        rects: Optional[Sequence] = None,
                        interpolation: str = "lanczos4"
                        ) -> Tuple[List, List, List]:
        """Reference-compatible: (pts_res, vertices_lst, poses) where each
        element i is ((3, 68) landmarks, (3, nver) vertices, [angles (3,),
        t3d (3,)]) for face i, in original-image coordinates. Without
        ``rects`` the faces come from :attr:`detector`."""
        if rects is None:
            rects = self.detector(img_bgr)
        if len(rects) == 0:
            return [], [], []
        roi_boxes = np.stack([square_box(r) for r in rects])
        frame = torch.from_numpy(np.ascontiguousarray(img_bgr, np.uint8)).to(
            self.device)
        crops = _crops_on(frame, roi_boxes, interpolation)
        rois = torch.as_tensor(roi_boxes[:, :4].astype(np.float32),
                               device=self.device)
        _, lmk, dense, angles, t3d = (x.cpu().numpy() for x in
                                      self._process(crops, rois))
        pts_res = [lmk[i] for i in range(len(rects))]
        vertices_lst = [dense[i] for i in range(len(rects))]
        poses = [[angles[i], t3d[i]] for i in range(len(rects))]
        return pts_res, vertices_lst, poses


class FusedFrameEngine:
    """Frame(s) -> up to ``max_faces`` faces per frame with landmarks, dense
    mesh and pose, all on the api's device. An f32 detector or regressor
    runs in full f32, TF32 off, as the JAX package computes by default; a
    bf16 one runs as it is."""

    def __init__(self, api: SynergyNet3DMM,
                 detector: Optional[FaceBoxes] = None, max_faces: int = 8):
        self.api = api
        self.detector = detector or FaceBoxes(device=api.device)
        if self.detector.device != api.device:
            raise ValueError(f"detector on {self.detector.device}, api on "
                             f"{api.device}")
        self.max_faces = max_faces
        self._det_mean = self.detector.mean

    def detect_candidates(self, frames_s2d: torch.Tensor,
                          true_hws: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, CH/8, CW/8, 192) s2d frames + (B, 2) true extents ->
        (scores (B, A) with -1 at ruled-out anchors, boxes (B, A, 4) in
        canvas pixels): :meth:`FaceBoxes.candidates`, TF32 off for an f32
        detector."""
        with full_fp32_if(self.detector.net.dtype):
            return self.detector.candidates(frames_s2d, true_hws)

    def select_faces(self, scores: torch.Tensor, boxes: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Top-k, greedy NMS, visibility filter, first ``max_faces`` kept
        (:func:`~synergynet_tpu_torch.detect.detector.rank_and_keep`):
        (face_scores (B, F) with -1 on padding rows, n_faces (B,),
        face_boxes (B, F, 4))."""
        top_scores, face_boxes, keep, _ = rank_and_keep(scores, boxes,
                                                        self.max_faces)
        face_scores = torch.where(keep, top_scores,
                                  torch.full_like(top_scores, -1.0))
        return face_scores, (face_scores > 0).sum(-1), face_boxes

    def regress(self, frames: torch.Tensor, rois: torch.Tensor
                ) -> torch.Tensor:
        """(B, CH, CW, 3) frames + (B, F, 4) rois -> param62 (B, F, 62),
        TF32 off for an f32 regressor."""
        b, f = rois.shape[:2]
        crops = crop_resize_matmul(frames, rois, CROP)
        xn = ((crops - 127.5) / 128.0).reshape(b * f, CROP, CROP, 3)
        with full_fp32_if(self.api.dtype):
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
        (N, 3, nver), angles (N, 3), t3d (N, 3)): the api's
        :meth:`SynergyNet3DMM.decode`."""
        return self.api.decode(param62, rois)

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
