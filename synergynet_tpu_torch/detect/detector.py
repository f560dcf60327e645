"""The FaceBoxes detector: the net, its anchors on the fixed canvas, the
weight tree in the topology it runs, candidate selection and the host calls.

Counterpart of ``synergynet_tpu/detect/detector.py``: its thresholds, its
canvas, ``_fit_scale``, the weight handling of ``FaceBoxes.__init__``
(``:92-160``: fold a raw tree and convert it to stem_r=8, take a folded or
pre-converted tree, or run the stem_r=4 or 3-channel topology, folded or
not), ``select_detections``
(``:54-74``: top-k 2048, greedy NMS at 0.3, visibility > 0.5, compacted to
``KEEP_TOP_K``) and the host calls ``FaceBoxes.detect_raw`` and
``FaceBoxes.__call__`` (``:187-213``), which fit the frame onto the canvas
with :func:`prepare_frame` (OpenCV's INTER_LINEAR downscale, bit for bit)
and run the net, the anchor decode and the selection on the detector's
device. The serving engine's ``select_faces`` shares the selection
(:func:`rank_and_keep`).

Weights come from ``variables``, from ``weights_path`` (a reference
``FaceBoxesProd.pth`` or an ``.npz`` tree, through
:mod:`synergynet_tpu_torch.detect.torch_import`), or by default
(:func:`default_variables`): the JAX package's cached conversion of the
reference checkpoint (``<assets>/faceboxes.npz``) when one exists, and
otherwise the JAX package's default init, flax's init from
``PRNGKey(0)``, exported once into this package's data
(``assets/faceboxes_flax_seed0.npz``, by
``scripts/export_faceboxes_seed0.py``), so both packages' default
detectors hold the same weights. The reference checkpoint is not in the
repository.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from synergynet_tpu_torch.convert import state_dict_from_flax
from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.core.paths import asset_dir
from synergynet_tpu_torch.detect.anchors import decode_boxes, generate_anchors
from synergynet_tpu_torch.detect.net import (FaceBoxesNet, fold_bn_variables,
                                             fold_to_s2d8, space_to_depth,
                                             variables_to_s2d)
from synergynet_tpu_torch.detect.torch_import import (
    load_faceboxes_variables, load_variables_npz)
from synergynet_tpu_torch.detect.nms import greedy_nms_mask
from synergynet_tpu_torch.mm3d.codec import full_fp32
from synergynet_tpu_torch.ops.resize import _resize_linear

CONFIDENCE_THRESHOLD = 0.05
NMS_THRESHOLD = 0.3
VIS_THRESHOLD = 0.5
KEEP_TOP_K = 750
MAX_HEIGHT, MAX_WIDTH = 720, 1080
BGR_MEAN = (104.0, 117.0, 123.0)

# Width rounded up to a multiple of 128; NMS_TOP_K bounds the candidates
# entering NMS (the reference admits 5000).
CANVAS = (MAX_HEIGHT, 1088)
NMS_TOP_K = 2048
STEM_R = 8

# The unfolded FaceBoxesNet tree: (module path, kh, kw, cin, cout).
BN_CONVS = (
    ("conv1", 7, 7, 3, 24), ("conv2", 5, 5, 48, 64),
    *((f"inception{i}/{b}", k, k, cin, cout)
      for i in (1, 2, 3)
      for b, k, cin, cout in (
          ("branch1x1", 1, 128, 32), ("branch1x1_2", 1, 128, 32),
          ("branch3x3_reduce", 1, 128, 24), ("branch3x3", 3, 24, 32),
          ("branch3x3_reduce_2", 1, 128, 24), ("branch3x3_2", 3, 24, 32),
          ("branch3x3_3", 3, 32, 32))),
    ("conv3_1", 1, 1, 128, 128), ("conv3_2", 3, 3, 128, 256),
    ("conv4_1", 1, 1, 256, 128), ("conv4_2", 3, 3, 128, 256),
)
HEADS = (("loc0", 128, 84), ("conf0", 128, 42), ("loc1", 256, 4),
         ("conf1", 256, 2), ("loc2", 256, 4), ("conf2", 256, 2))


def _fit_scale(h: int, w: int) -> float:
    """Reference downscale rule: fit h<=720 then w<=1080, never upscale."""
    scale = 1.0
    if h > MAX_HEIGHT:
        scale = MAX_HEIGHT / h
    if w * scale > MAX_WIDTH:
        scale *= MAX_WIDTH / (w * scale)
    return scale


def prepare_frame(img_bgr: np.ndarray, stem_r: int, device="cuda"):
    """Fit a BGR uint8 frame onto the fixed detector canvas on ``device``
    (the card unless the caller asks for the CPU).

    Returns (canvas f32 (CH, CW, 3), s2d-packed canvas, true_hw int32 (2,),
    scale): frames larger than 720x1080 scale down by the reference rule
    (``cv2.resize``'s INTER_LINEAR, bit for bit) and sit at the canvas
    origin on a zero border."""
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


def rank_and_keep(scores: torch.Tensor, boxes: torch.Tensor, n_out: int,
                  top_k: int = NMS_TOP_K
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Candidate selection after scoring, batched over frames: scores
    (B, A) with -1 at ruled-out anchors, boxes (B, A, 4) -> the first
    ``n_out`` of the ``top_k`` best candidates with kept ones first (their
    scores (B, n), boxes (B, n, 4) and keep flags (B, n)) and the kept
    count (B,).

    Top-k, greedy NMS at ``NMS_THRESHOLD`` over the positive scores, keep
    those above ``VIS_THRESHOLD``, then a stable partition of kept before
    dropped. Stable sorts give ``lax.top_k``'s and
    ``argsort(stable=True)``'s lower-index-first order on ties."""
    k = min(top_k, scores.shape[-1])
    top_scores, idx = torch.sort(scores, dim=-1, descending=True,
                                 stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    keep = greedy_nms_mask(top_boxes, top_scores > 0.0, NMS_THRESHOLD)
    keep &= top_scores > VIS_THRESHOLD
    order = torch.argsort((~keep).to(torch.uint8), dim=-1,
                          stable=True)[:, :n_out]
    return (torch.gather(top_scores, 1, order),
            torch.gather(top_boxes, 1, order[..., None].expand(-1, -1, 4)),
            torch.gather(keep, 1, order), keep.sum(-1))


def select_detections(boxes: torch.Tensor, scores: torch.Tensor,
                      top_k: int = NMS_TOP_K
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's selection, the JAX package's ``select_detections``:
    boxes (A, 4) and scores (A,) with -1 at ruled-out anchors -> (dets
    (KEEP_TOP_K, 5) [x1, y1, x2, y2, score], kept rows first; count =
    min(kept, KEEP_TOP_K)) on the inputs' device; fewer rows when fewer
    than ``KEEP_TOP_K`` candidates enter NMS."""
    ts, tb, _, n = rank_and_keep(scores[None], boxes[None], KEEP_TOP_K,
                                 top_k)
    dets = torch.cat([tb[0], ts[0, :, None]], dim=1)
    return dets, torch.clamp(n[0], max=KEEP_TOP_K)


def random_init_variables(seed: int = 0) -> dict:
    """A seeded random unfolded FaceBoxesNet tree in flax layout, drawn from
    a ``torch.Generator``: conv kernels lecun-normal (std sqrt(1/fan_in),
    untruncated), biases zero, BatchNorm identity — flax's initializers."""
    g = torch.Generator().manual_seed(seed)

    def kernel(kh, kw, cin, cout):
        k = torch.randn((kh, kw, cin, cout), generator=g)
        return (k / math.sqrt(kh * kw * cin)).numpy()

    params: dict = {}
    stats: dict = {}

    def put(tree, path, leaf):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf

    for name, kh, kw, cin, cout in BN_CONVS:
        path = tuple(name.split("/"))
        put(params, path + ("conv", "kernel"), kernel(kh, kw, cin, cout))
        put(params, path + ("bn", "scale"), np.ones(cout, np.float32))
        put(params, path + ("bn", "bias"), np.zeros(cout, np.float32))
        put(stats, path + ("bn", "mean"), np.zeros(cout, np.float32))
        put(stats, path + ("bn", "var"), np.ones(cout, np.float32))
    for name, cin, cout in HEADS:
        params[name] = {"kernel": kernel(3, 3, cin, cout),
                        "bias": np.zeros(cout, np.float32)}
    return {"params": params, "batch_stats": stats}


# The JAX package's ``random_init_variables(0)``
# (``synergynet_tpu/detect/torch_import.py:129-132``) as flat float32 leaves.
JAX_SEED0_INIT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "faceboxes_flax_seed0.npz")


def default_variables(seed: int = 0) -> dict:
    """The JAX package's cached detector weights (``<assets>/faceboxes.npz``)
    when present; else, for ``seed`` 0, the JAX package's default init
    (:data:`JAX_SEED0_INIT`); else :func:`random_init_variables`."""
    cache = os.path.join(asset_dir(), "faceboxes.npz")
    if os.path.exists(cache):
        return load_variables_npz(cache)
    if seed == 0:
        return load_variables_npz(JAX_SEED0_INIT)
    return random_init_variables(seed)


def convert_for_topology(variables: dict, stem_s2d: bool = True,
                         fold_bn: bool = True, stem_r: int = 8
                         ) -> Tuple[dict, bool, int]:
    """A FaceBoxesNet tree -> (tree, folded, stem_r) of the topology it
    runs, as the JAX ``FaceBoxes.__init__`` decides: a pre-converted
    ``conv1_s2d8`` tree as-is (it needs ``stem_s2d``); stem_r=8 from a 7x7
    conv1 when folding (a raw tree folds first, a folded one, conv bias
    present, converts directly); otherwise stem_r=4 (or 1 without
    ``stem_s2d``), the 7x7 kernel re-laid out for s2d, folded when asked or
    already folded."""
    params = variables["params"]
    stem_r = stem_r if stem_s2d else 1
    if "conv1_s2d8" in params:
        if not stem_s2d:
            raise ValueError(
                "the variable tree is pre-converted for the deep-s2d stem "
                "(conv1_s2d8) but stem_s2d=False was requested — a 3-channel "
                "net cannot apply it; pass stem_s2d=True or an unconverted "
                "tree")
        return variables, True, 8
    conv1 = params["conv1"]["conv"]
    seven = np.shape(conv1["kernel"])[0] == 7
    already_folded = "bias" in conv1
    if stem_r == 8 and fold_bn and seven:
        if not already_folded:
            variables = fold_bn_variables(variables)
        return fold_to_s2d8(variables), True, 8
    if stem_r == 8:
        stem_r = 4
    if stem_s2d and seven:
        variables = variables_to_s2d(variables)
    if fold_bn and not already_folded:
        variables = fold_bn_variables(variables)
    return variables, fold_bn or already_folded, stem_r


class FaceBoxes:
    """The detector: ``net`` (:class:`FaceBoxesNet` on ``device``, the card
    unless the caller asks for the CPU), ``anchors`` (A, 4) on ``device``
    for the fixed canvas, and ``variables`` (the flax-layout tree the net
    was loaded from, in its topology). Weights: ``variables``, else
    ``weights_path`` (a reference ``.pth`` or an ``.npz`` tree), else the
    default weights for ``seed``. By default the tree is folded and
    converted to the stem_r=8 net; ``fold_bn=False``, ``stem_r=4``,
    ``stem_s2d=False`` or a tree already in one of those forms run that
    topology (``stem_r`` is then 4, or 1 for the 3-channel stem).
    ``stem_mode="pallas"`` runs the stem_r=8 stem through the fused kernel
    (``csrc/stem_s2d8.cu``, bf16 or f32). Called on a BGR uint8 frame, it
    returns the reference's ``[[x1, y1, x2, y2, score], ...]``; construct
    once and reuse."""

    def __init__(self, variables: Optional[dict] = None,
                 weights_path: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, stem_s2d: bool = True,
                 fold_bn: bool = True, stem_r: int = STEM_R,
                 stem_mode: Optional[str] = None, device="cuda",
                 seed: int = 0):
        self.device = resolve_device(device)
        if variables is None:
            variables = load_faceboxes_variables(weights_path, seed)
        self.variables, self.fold_bn, self.stem_r = convert_for_topology(
            variables, stem_s2d, fold_bn, stem_r)
        self.stem_s2d = stem_s2d
        net = FaceBoxesNet(dtype=dtype, stem_mode=stem_mode,
                           stem_s2d=stem_s2d, folded=self.fold_bn,
                           stem_r=self.stem_r if stem_s2d else 4)
        net.load_state_dict(state_dict_from_flax(self.variables))
        self.net = net.to(self.device).eval()
        h, w = CANVAS
        self.anchors = torch.tensor(generate_anchors(h, w),
                                    device=self.device)
        self.mean = torch.tensor(np.tile(BGR_MEAN, self.stem_r ** 2),
                                 dtype=torch.float32, device=self.device)

    def candidates(self, frames_s2d: torch.Tensor, true_hws: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, CH/r, CW/r, 3r^2) s2d frames (r = ``stem_r``) + (B, 2) true
        extents -> (scores (B, A) with -1 at ruled-out anchors: below
        ``CONFIDENCE_THRESHOLD`` or centred in the canvas padding; boxes
        (B, A, 4) in canvas pixels, unclipped)."""
        ch, cw = CANVAS
        loc, conf = self.net(frames_s2d - self.mean)
        scores = torch.softmax(conf, dim=-1)[..., 1]
        boxes = decode_boxes(loc, self.anchors) * torch.tensor(
            [cw, ch, cw, ch], dtype=torch.float32, device=loc.device)
        th = true_hws[:, 0:1].float()
        tw = true_hws[:, 1:2].float()
        cx = (boxes[..., 0] + boxes[..., 2]) / 2
        cy = (boxes[..., 1] + boxes[..., 3]) / 2
        ok = (cx < tw) & (cy < th) & (scores > CONFIDENCE_THRESHOLD)
        return torch.where(ok, scores, torch.full_like(scores, -1.0)), boxes

    @torch.inference_mode()
    def detect_raw(self, img_bgr: np.ndarray) -> Tuple[np.ndarray, int]:
        """One BGR uint8 frame -> (dets (KEEP_TOP_K, 5) float32 numpy, boxes
        in original pixels, kept rows first; count). An f32 net runs in
        full f32, TF32 off, as the JAX package's detector computes by
        default."""
        _, packed, true_hw, scale = prepare_frame(img_bgr, self.stem_r,
                                                  self.device)
        with full_fp32():
            scores, boxes = self.candidates(packed[None], true_hw[None])
        dets, count = select_detections(boxes[0], scores[0])
        dets = dets.cpu().numpy()
        dets[:, :4] /= scale
        return dets, int(count)

    def __call__(self, img_bgr: np.ndarray) -> List[List[float]]:
        """One BGR uint8 frame -> [[x1, y1, x2, y2, score], ...] for every
        kept face, in original pixels (the reference's ``FaceBoxes``)."""
        dets, count = self.detect_raw(img_bgr)
        return [list(map(float, dets[i])) for i in range(count)]
