"""The weights both sides are given: drawn from the seed on the device, or
read from the shipped file.

A seeded tree is one ``torch.randn`` of all its leaves on the device, from
a ``torch.Generator`` there, cut into leaves and scaled by kind: kernels
lecun-normal (standard deviation sqrt(1 / fan_in), flax's default), biases
0.01, BatchNorm scale 1 + 0.1 |N| and shift 0.1 N; the last BatchNorm of
a residual branch scales by a fifth of that, as trained residual nets keep
it small (drawn at full scale, a random ResNeSt-50 is chaotic: an input
change of 1e-3 moves its output by 0.3). The running statistics
are then set as training would leave them: each BatchNorm's mean and
variance are those of its input in one float32 pass of the reference over
what the net sees in service (the detector: two seeded noise canvases; a
regressor: the reference's crops of the detector's 32 best boxes on each
of them, borders off the canvas and small boxes blown up included), so
activations stay near unit scale as in a trained net on any crop the
cells make, and folding the statistics into the served convolutions is
real work. A drawn regressor's head is then scaled so that each of its
62 outputs has a root mean square of 1 over the same crops, the scale of
a trained one's whitened parameters (a random deep net maps every crop
near one output, so its spread is not whitened away).
The shipped regressor file is read with numpy (float16 leaves to float32).

Each tree comes twice: the reference's tensors on the device (params and
statistics merged, :func:`perfbench.reference.nets.merge`) and the flax
layout with numpy leaves that the program's constructors take.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from perfbench.reference import nets, regressors
from perfbench.reference import pipeline as P
from perfbench.reference.nets import leaf_specs, merge
from perfbench.reference.precision import Precision, exact_f32


def stream(seed: int, k: int) -> int:
    """The seed of stream ``k`` of a run (weights, frames, samples)."""
    return (int(seed) * 1_000_003 + k) % (2 ** 63)


def _put(tree: dict, path, leaf) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = leaf


def draw(spec, seed: int, device) -> Dict[str, dict]:
    """``{"params": ..., "batch_stats": ...}`` of tensors on ``device``."""
    n = sum(math.prod(shape) for _, _, shape, _ in spec)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n, generator=g, device=device)
    tree: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    at = 0
    for col, path, shape, kind in spec:
        size = math.prod(shape)
        x = flat[at:at + size].reshape(shape)
        at += size
        if kind == "kernel":
            x = x * math.sqrt(1.0 / math.prod(shape[:-1]))
        elif kind == "dense":
            x = x * math.sqrt(1.0 / shape[0])
        elif kind == "bias":
            x = x * 0.01
        elif kind in ("bn_scale", "bn_var"):
            x = 1.0 + 0.1 * x.abs()
        elif kind == "bn_scale_residual":
            x = 0.2 * (1.0 + 0.1 * x.abs())
        else:                                   # bn_bias, bn_mean
            x = 0.1 * x
        _put(tree[col], path, x.contiguous())
    return tree


def _mark(tree: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            if "mean" in v and "var" in v:
                v["calibrate"] = True
            else:
                _mark(v)


def calibrate(arch: str, tree: dict, x: torch.Tensor) -> None:
    """Set every running statistic of a drawn ``tree`` from a pass of the
    reference over ``x`` (see the module doc), in place: canvases for the
    detector (``arch`` "faceboxes"), normalized crops for a regressor
    (``arch`` its architecture)."""
    ref = merge(tree["params"], tree["batch_stats"])
    _mark(ref)
    p = Precision("f32")
    with exact_f32(), torch.no_grad():
        if arch == "faceboxes":
            nets.faceboxes(p, ref, x - torch.tensor(P.BGR_MEAN,
                                                    device=x.device))
        else:
            y = regressors.load(arch).forward(p, ref["backbone"], x)
            rms = (y * y).mean(0).sqrt()
            head = tree["params"]["backbone"]["ParamHead_0"]
            at = 0
            for name, n in nets.HEAD:
                sl = slice(at, at + n)
                head[name]["kernel"] = head[name]["kernel"] / rms[sl]
                head[name]["bias"] = head[name]["bias"] / rms[sl]
                at += n

    def copy(stats, node):
        for k, v in stats.items():
            if isinstance(v, dict):
                copy(v, node[k])
            else:
                stats[k] = node[k].contiguous()

    copy(tree["batch_stats"], ref)


def _service_crops(det_tree: dict, canvases: torch.Tensor, size: int,
                   per_frame=32):
    """The reference's normalized ``size`` x ``size`` crops of the
    detector's best boxes."""
    det = merge(det_tree["params"], det_tree["batch_stats"])
    hw = torch.tensor([canvases.shape[1:3]] * len(canvases),
                      device=canvases.device)
    p = Precision("f32")
    with exact_f32(), torch.no_grad():
        c = P.candidates(p, det, canvases, hw, P.anchors(
            canvases.shape[1], canvases.shape[2], canvases.device))
        _, boxes, _ = P.top_candidates(c, per_frame)
        rois = P.square_rois(boxes)
        crops = torch.cat([P.crop(canvases[i], rois[i], size)
                           for i in range(len(canvases))])
    return (crops - 127.5) / 128.0


def read_npz(path: str, device) -> Dict[str, dict]:
    """A flat ``.params/...`` / ``.batch_stats/...`` file -> the tree of
    tensors on ``device``."""
    tree: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            parts = key.split("/")
            col = parts[0].lstrip(".")
            if col in tree:
                _put(tree[col], parts[1:], torch.tensor(
                    z[key].astype(np.float32), device=device))
    return tree


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def configuration_weights(cfg: dict, root: str, seed: int, device
                          ) -> Tuple[dict, dict]:
    """(reference trees, program trees) of a configuration:
    ``detector`` and ``regressor`` each."""
    arch = cfg["regressor"]["arch"]
    specs = leaf_specs(arch)
    trees = {"detector": draw(specs["detector"], stream(seed, 1), device)}
    g = torch.Generator(device=device).manual_seed(stream(seed, 5))
    canvases = torch.randint(0, 256, (2,) + tuple(cfg["canvas"]) + (3,),
                             generator=g, device=device).float()
    calibrate("faceboxes", trees["detector"], canvases)
    src = cfg["regressor"]["weights"]
    if src == "seeded":
        if "regressor" not in specs:
            raise ValueError(f"regressor {arch!r} draws no seeded tree")
        trees["regressor"] = draw(specs["regressor"], stream(seed, 2), device)
        calibrate(arch, trees["regressor"], _service_crops(
            trees["detector"], canvases, cfg["regressor"]["crop"]))
    else:
        trees["regressor"] = read_npz(f"{root}/{src}", device)
    ref = {"detector": merge(trees["detector"]["params"],
                             trees["detector"]["batch_stats"]),
           "regressor": merge(trees["regressor"]["params"],
                              trees["regressor"]["batch_stats"]
                              )["backbone"]}
    return ref, {k: numpy_tree(v) for k, v in trees.items()}
