"""The FaceBoxes detector as the serving path holds it: the folded s2d8
net, its anchors on the fixed canvas, and the folded weight tree.

Counterpart of ``synergynet_tpu/detect/detector.py``: its thresholds, its
canvas, ``_fit_scale``, and the weight handling of ``FaceBoxes.__init__``
(``:111-154``) for the stem_r=8 topology. The candidate selection itself
(top-k, NMS, keep) lives in the serving engine, as in the JAX package.

Without weights, the detector loads the JAX package's cached conversion of
the reference checkpoint (``<assets>/faceboxes.npz``) when one exists, and
otherwise builds a seeded random init — the reference checkpoint is not in
the repository.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from synergynet_tpu_torch.convert import faceboxes_state_dict
from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.core.paths import asset_dir
from synergynet_tpu_torch.detect.anchors import generate_anchors
from synergynet_tpu_torch.detect.net import (FaceBoxesNet, fold_bn_variables,
                                             fold_to_s2d8)

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
_BN_CONVS = (
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
_HEADS = (("loc0", 128, 84), ("conf0", 128, 42), ("loc1", 256, 4),
          ("conf1", 256, 2), ("loc2", 256, 4), ("conf2", 256, 2))


def _fit_scale(h: int, w: int) -> float:
    """Reference downscale rule: fit h<=720 then w<=1080, never upscale."""
    scale = 1.0
    if h > MAX_HEIGHT:
        scale = MAX_HEIGHT / h
    if w * scale > MAX_WIDTH:
        scale *= MAX_WIDTH / (w * scale)
    return scale


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

    for name, kh, kw, cin, cout in _BN_CONVS:
        path = tuple(name.split("/"))
        put(params, path + ("conv", "kernel"), kernel(kh, kw, cin, cout))
        put(params, path + ("bn", "scale"), np.ones(cout, np.float32))
        put(params, path + ("bn", "bias"), np.zeros(cout, np.float32))
        put(stats, path + ("bn", "mean"), np.zeros(cout, np.float32))
        put(stats, path + ("bn", "var"), np.ones(cout, np.float32))
    for name, cin, cout in _HEADS:
        params[name] = {"kernel": kernel(3, 3, cin, cout),
                        "bias": np.zeros(cout, np.float32)}
    return {"params": params, "batch_stats": stats}


def _load_npz_tree(path: str) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree


def load_faceboxes_variables(seed: int = 0) -> dict:
    """The JAX package's cached detector weights (``<assets>/faceboxes.npz``)
    when present, else :func:`random_init_variables`."""
    cache = os.path.join(asset_dir(), "faceboxes.npz")
    if os.path.exists(cache):
        return _load_npz_tree(cache)
    return random_init_variables(seed)


def to_folded_s2d8(variables: dict) -> dict:
    """Any FaceBoxesNet tree -> the folded stem_r=8 tree, as
    ``FaceBoxes.__init__`` converts it: a pre-converted tree as-is, a folded
    tree (conv1 bias present) through :func:`fold_to_s2d8`, a raw tree
    through :func:`fold_bn_variables` first."""
    params = variables["params"]
    if "conv1_s2d8" in params:
        return variables
    conv1 = params["conv1"]["conv"]
    if np.shape(conv1["kernel"])[0] != 7:
        raise ValueError("the stem_r=8 detector converts from the 7x7 stem "
                         f"kernel, got {np.shape(conv1['kernel'])}")
    if "bias" not in conv1:
        variables = fold_bn_variables(variables)
    return fold_to_s2d8(variables)


class FaceBoxes:
    """The serving detector: ``net`` (folded s2d8 :class:`FaceBoxesNet` on
    ``device``, the card unless the caller asks for the CPU), ``anchors``
    (A, 4) on ``device`` for the fixed canvas, and ``variables`` (the folded
    flax-layout tree the net was loaded from). ``stem_mode="pallas"`` runs
    the stem through the fused kernel (``csrc/stem_s2d8.cu``)."""

    stem_s2d = True
    stem_r = STEM_R

    def __init__(self, variables: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 stem_mode: Optional[str] = None, seed: int = 0):
        self.device = resolve_device(device)
        if variables is None:
            variables = load_faceboxes_variables(seed)
        self.variables = to_folded_s2d8(variables)
        net = FaceBoxesNet(dtype=dtype, stem_mode=stem_mode)
        net.load_state_dict(faceboxes_state_dict(self.variables))
        self.net = net.to(self.device).eval()
        h, w = CANVAS
        self.anchors = torch.tensor(generate_anchors(h, w),
                                    device=self.device)
