"""Serving API: frames -> faces -> (landmarks, dense meshes, poses).

Counterpart of ``synergynet_tpu/pipeline/api.py``:

- :class:`SynergyNet3DMM` holds the regressor, the 3DMM pack and the
  coordinate-split dense basis on one device, with the side its faces are
  cropped at (``crop``: 120 as SynergyNet ships), and is the packaged
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

The JAX package compiles the engine into one program per batch size. On a
card, ``process_batch`` replays a CUDA graph of its eager body
(:meth:`FusedFrameEngine.process_batch_eager`), captured on the first call
of each batch size (:mod:`synergynet_tpu_torch.pipeline.program`); greedy
NMS runs kernel N1 on the device, so nothing inside reads the host.
``__call__`` replays the one-frame program and then reads the face count,
as the JAX package's ``__call__`` reads its outputs. On the CPU the eager
body runs.

What an operator can read (:mod:`synergynet_tpu_torch.core.profiling`,
``recorder``): each ``process_batch.b<B>`` program stamps ``BATCH_STAGES``
into its own ring (device ms per stage of every replay:
``recorder.stage_ms``) and its body tallies ``TALLIES`` (candidates with a
positive score, candidates kept by greedy NMS and the visibility
threshold, faces returned) and those its regressor's modules list (their
``tallies``: a mixture-of-experts regressor's routed rows and busiest
experts' rows, :mod:`synergynet_tpu_torch.nn.moe`), read with the
program's calls, frames and bytes by ``recorder.counters``; under a
profiler the calls show the spans
``synergy.process_batch`` and, in ``__call__``, ``synergy.frame`` >
``synergy.prep`` (fit, upload, pack: host work and its uploads),
``synergy.to_host`` (the outputs' copies to numpy: where the host waits
for the device) and ``synergy.unpack`` (host work).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from synergynet_tpu_torch.convert import synergy_state_dict
from synergynet_tpu_torch.core.checkpoint import load_shipped_trained
from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.core.profiling import annotate, stage_done, tally
from synergynet_tpu_torch.detect.detector import (FaceBoxes, prepare_frame,
                                                  rank_and_keep)
from synergynet_tpu_torch.mm3d.assets import N_LMK, ParamPack, load_param_pack
from synergynet_tpu_torch.mm3d.codec import (decode_landmarks, full_fp32,
                                             full_fp32_if, rescale_to_roi)
from synergynet_tpu_torch.mm3d.crop import crop_rect, square_box
from synergynet_tpu_torch.mm3d.pose import (pose_from_param,
                                            rescale_pose_to_roi)
from synergynet_tpu_torch.nn.layers import cast_layers_
from synergynet_tpu_torch.nn.synergy import (SynergyNet,
                                             init_synergy_variables)
from synergynet_tpu_torch.ops.fused_decode import (build_decode_basis,
                                                   decode_dense_fused)
from synergynet_tpu_torch.ops.resize import crop_resize_cv2
from synergynet_tpu_torch.pipeline.device_crop import (crop_resize_bilinear,
                                                       square_rois)
from synergynet_tpu_torch.pipeline.program import ProgramCache

CROP = 120              # SynergyNet's crop side: the API's default
MAX_FACES_PER_BATCH = 16
# The device intervals of one process_batch call, between its eight stamps:
# copy-in (and the graph's launch), detect, select (top-k sort, N1, keep),
# crop, regress (the backbone alone), decode (landmarks, B1, pose,
# rescale), clone-out.
BATCH_STAGES = ("copy_in", "detect", "select", "crop", "regress", "decode",
                "clone_out")
TALLIES = ("valid", "kept", "faces")


def _crops_on(frame: torch.Tensor, roi_boxes: Sequence, interpolation: str,
              size: int = CROP) -> torch.Tensor:
    """(H, W, 3) uint8 frame on its device + N roi boxes -> (N, size, size,
    3) uint8 on that device."""
    return crop_resize_cv2(frame, [crop_rect(rb) for rb in roi_boxes], size,
                           interpolation)


def preprocess_crops(img_bgr: np.ndarray, roi_boxes: Sequence[np.ndarray],
                     interpolation: str = "lanczos4", device="cuda",
                     size: int = CROP) -> np.ndarray:
    """Crop + resize every roi to a (N, size, size, 3) uint8 stack, equal
    bit for bit to ``cv2.resize(crop_img(img, roi), (size, size),
    interpolation=...)`` (at 120 the JAX package's):
    ``'lanczos4'`` (packaged API, synergy3DMM.py:188) or ``'linear'`` (demo
    script, singleImage.py:77 -- quirk Q7). The frame is uploaded once and
    every face resampled in one batched gather on ``device`` (the card
    unless the caller asks for the CPU)."""
    frame = torch.from_numpy(np.ascontiguousarray(img_bgr, np.uint8)).to(
        resolve_device(device))
    return _crops_on(frame, roi_boxes, interpolation, size).cpu().numpy()


class SynergyNet3DMM:
    """The regressor and 3DMM constants on ``device`` (the card unless
    the caller asks for the CPU; raises when there is no card). Construct
    once; call :meth:`get_all_outputs` per image. The parameters bind
    positionally as the JAX class's, ``(arch, variables, pack, detector,
    dtype, seed)``, with ``device`` and ``crop`` after them.

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
    rects; built on first use on the same device when not given. ``crop``
    (``self.crop``): the side every face is cropped at, by the host crops
    and by :class:`FusedFrameEngine`; by default the side the backbone
    fixes (``input_size``: a Vision Transformer's position embedding), else
    ``CROP``. A ``crop`` that the backbone's fixed side does not match
    raises a ``ValueError`` here.
    """

    def __init__(self, arch: str = "mobilenet_v2",
                 variables: dict | str | None = None,
                 pack: Optional[ParamPack] = None,
                 detector: Optional[FaceBoxes] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 device="cuda", crop: Optional[int] = None):
        self.device = resolve_device(device)
        if isinstance(variables, str):
            if variables != "trained":
                raise ValueError(f"unknown variables spec {variables!r} "
                                 "(only 'trained' is recognised)")
            variables = load_shipped_trained(arch)
        self.dtype = dtype
        self.pack = pack if pack is not None else load_param_pack()
        model = SynergyNet(arch=arch, dtype=dtype)
        fixed = getattr(model.backbone, "input_size", None)
        if crop is None:
            crop = CROP if fixed is None else fixed
        elif fixed not in (None, crop):
            raise ValueError(f"backbone {arch!r} takes {fixed} x {fixed} "
                             f"crops; the API crops at {crop}")
        self.crop = crop
        if variables is None:
            variables = init_synergy_variables(
                model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(synergy_state_dict(variables))
        cast_layers_(model, dtype)
        # A backbone may store other widths to serve than it publishes
        # (HRNet's narrow branches); ``variables`` keeps the published.
        getattr(model.backbone, "pad_channels_", lambda: None)()
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
        """(N, crop, crop, 3) uint8 crops + (N, 4) f32 rois on the device ->
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
        """Batched core: (N, crop, crop, 3) uint8 crops (numpy or a tensor)
        + (N, 4+) roi boxes -> (param62, lmk, dense, angles, t3d) numpy
        arrays with leading dim N, in the rois' image coordinates. At zero
        faces the five arrays are empty with the contract's trailing
        shapes. Crops of another side raise."""
        n = len(crops_u8)
        if n and tuple(crops_u8.shape[1:3]) != (self.crop, self.crop):
            raise ValueError(f"crops of {tuple(crops_u8.shape[1:3])}; the "
                             f"API crops at {self.crop}")
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
        crops = _crops_on(frame, roi_boxes, interpolation, self.crop)
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
    bf16 one runs as it is. On a card, :meth:`process_batch` replays one
    captured program per batch size (``programs``)."""

    def __init__(self, api: SynergyNet3DMM,
                 detector: Optional[FaceBoxes] = None, max_faces: int = 8):
        self.api = api
        self.detector = detector or FaceBoxes(device=api.device)
        if self.detector.device != api.device:
            raise ValueError(f"detector on {self.detector.device}, api on "
                             f"{api.device}")
        self.max_faces = max_faces
        self._det_mean = self.detector.mean
        # Built now: the path's kernel libraries and those its backbone's
        # modules launch (their ``kernels``). The body tallies ``TALLIES``
        # and what the modules add to (their ``tallies``).
        nets = {k for m in api.model.modules()
                for k in getattr(m, "kernels", ())}
        self.tallies = TALLIES + tuple(dict.fromkeys(
            t for m in api.model.modules()
            for t in getattr(m, "tallies", ())))
        self.programs = ProgramCache(
            api.device, "frame",
            kernels=("stem_s2d8", "nms_greedy", "crop_bilinear",
                     "fused_decode", *sorted(nets)))

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
        top_scores, face_boxes, keep, kept = rank_and_keep(scores, boxes,
                                                           self.max_faces)
        face_scores = torch.where(keep, top_scores,
                                  torch.full_like(top_scores, -1.0))
        n_faces = (face_scores > 0).sum(-1)
        tally(lambda: ((scores > 0).sum(), kept.sum(), n_faces.sum()),
              TALLIES)
        return face_scores, n_faces, face_boxes

    def regress(self, frames: torch.Tensor, rois: torch.Tensor
                ) -> torch.Tensor:
        """(B, CH, CW, 3) frames + (B, F, 4) rois -> param62 (B, F, 62),
        the faces cropped at the api's ``crop``, TF32 off for an f32
        regressor."""
        b, f = rois.shape[:2]
        size = self.api.crop
        crops = crop_resize_bilinear(frames, rois, size)
        stage_done("crop")
        xn = ((crops - 127.5) / 128.0).reshape(b * f, size, size, 3)
        with full_fp32_if(self.api.dtype):
            param62, _ = self.api.model(xn)
        param62 = param62.float().reshape(b, f, -1)
        stage_done("regress")
        return param62

    def head(self, frames, frames_s2d, true_hws):
        """Detect + crop + regress for B frames -> (face_scores (B, F),
        n_faces (B,), rois (B, F, 4), param62 (B, F, 62))."""
        scores, boxes = self.detect_candidates(frames_s2d, true_hws)
        stage_done("detect")
        face_scores, n_faces, face_boxes = self.select_faces(scores, boxes)
        rois = square_rois(face_boxes)
        stage_done("select")
        return face_scores, n_faces, rois, self.regress(frames, rois)

    def tail(self, param62: torch.Tensor, rois: torch.Tensor):
        """Flat (N, 62) params + (N, 4) rois -> (lmk (N, 3, 68), dense
        (N, 3, nver), angles (N, 3), t3d (N, 3)): the api's
        :meth:`SynergyNet3DMM.decode`."""
        return self.api.decode(param62, rois)

    @torch.inference_mode()
    def process_batch_eager(self, frames: torch.Tensor,
                            frames_s2d: torch.Tensor, true_hws: torch.Tensor):
        """The eager body of :meth:`process_batch`, op by op on the frames'
        device: what a card's program captures and what the CPU runs. Run
        by its program it stamps ``BATCH_STAGES`` and tallies
        ``self.tallies`` (module docstring); called directly, like a stage
        called on its own, it stamps nothing."""
        face_scores, n_faces, rois, param62 = self.head(frames, frames_s2d,
                                                        true_hws)
        b, f = rois.shape[:2]
        outs = self.tail(param62.reshape(b * f, -1), rois.reshape(b * f, -1))
        lmk, dense, angles, t3d = (x.reshape(b, f, *x.shape[1:])
                                   for x in outs)
        stage_done("decode")
        return (face_scores, n_faces, rois, param62, lmk, dense, angles, t3d)

    @torch.inference_mode()
    def process_batch(self, frames: torch.Tensor, frames_s2d: torch.Tensor,
                      true_hws: torch.Tensor):
        """Batched serving: (B, 720, 1088, 3) f32 frames, their s2d packing
        and (B, 2) true extents -> (face_scores, n_faces, rois, param62,
        lmk, dense, angles, t3d), each with leading dims (B, max_faces)
        (n_faces: (B,)). The decode tail runs once on the B*max_faces rows.
        Frames on a card replay the captured program of their batch size
        (captured on its first call; fresh output tensors each call);
        frames on the CPU run :meth:`process_batch_eager`."""
        with annotate("synergy.process_batch"):
            return self.programs.run(
                f"process_batch.b{frames.shape[0]}", self.process_batch_eager,
                frames, frames_s2d, true_hws, stages=BATCH_STAGES,
                tallies=self.tallies)

    def __call__(self, img_bgr: np.ndarray) -> Tuple[List, List, List]:
        """One BGR uint8 frame -> reference-format (pts_res, vertices_lst,
        poses) in original-image coordinates, as numpy."""
        with annotate("synergy.frame"):
            with annotate("synergy.prep"):
                canvas, packed, true_hw, scale = prepare_frame(
                    img_bgr, self.detector.stem_r, self.api.device)
            out = self.process_batch(canvas[None], packed[None],
                                     true_hw[None])
            with annotate("synergy.to_host"):
                _, n, _, _, lmk, dense, angles, t3d = [x[0].cpu().numpy()
                                                       for x in out]
            with annotate("synergy.unpack"):
                return unpack_face_outputs(int(n), lmk, dense, angles, t3d,
                                           scale)


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
