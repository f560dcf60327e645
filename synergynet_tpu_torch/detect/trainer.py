"""FaceBoxes detector training: the SSD multibox objective on the port.

Counterpart of ``synergynet_tpu/detect/trainer.py``: the reference ships
the training-side box code (FaceBoxes/utils/box_utils.py:98-173) but no
trainer. :class:`DetectorTrainer` trains the unfolded 3-channel
FaceBoxesNet (BatchNorm in train mode) with anchor matching and the
multibox loss of :mod:`synergynet_tpu_torch.detect.train_utils`, SGD with
Nesterov momentum as ``optax.sgd(lr, momentum, nesterov=True)`` computes
it, on frames minus ``BGR_MEAN`` (the serving path's input transform), in
full f32 (TF32 off). :func:`make_synthetic_detection_batch` makes bright
square "faces" on dark noise, the JAX function's draws in the same order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from synergynet_tpu_torch.convert import (flax_from_state_dict,
                                          state_dict_from_flax)
from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.detect.anchors import generate_anchors
from synergynet_tpu_torch.detect.net import FaceBoxesNet
from synergynet_tpu_torch.detect.train_utils import match, multibox_loss
from synergynet_tpu_torch.mm3d.codec import full_fp32
from synergynet_tpu_torch.train.step import TrainState


def make_synthetic_detection_batch(rng: np.random.Generator, batch: int,
                                   size: Tuple[int, int] = (256, 256),
                                   max_faces: int = 4
                                   ) -> Dict[str, np.ndarray]:
    """Frames with bright square faces on dark noise and their normalized
    corner boxes, padded to ``max_faces`` with a validity mask."""
    h, w = size
    images = rng.integers(0, 60, (batch, h, w, 3)).astype(np.float32)
    boxes = np.zeros((batch, max_faces, 4), np.float32)
    valid = np.zeros((batch, max_faces), bool)
    for b in range(batch):
        n = int(rng.integers(1, max_faces + 1))
        for k in range(n):
            side = int(rng.integers(32, 96))
            x0 = int(rng.integers(0, w - side))
            y0 = int(rng.integers(0, h - side))
            images[b, y0:y0 + side, x0:x0 + side] = rng.integers(
                170, 255, 3).astype(np.float32)
            boxes[b, k] = [x0 / w, y0 / h, (x0 + side) / w, (y0 + side) / h]
            valid[b, k] = True
    return {"images": images, "boxes": boxes, "valid": valid}


class DetectorTrainer:
    """Trains an unfolded 3-channel ``FaceBoxesNet`` on ``device`` (the card
    unless the caller asks for the CPU). Weights: ``variables`` (a flax
    tree, such as the JAX trainer's ``variables``), else drawn from
    ``seed`` (:func:`~synergynet_tpu_torch.detect.detector.
    random_init_variables`, flax's initializers). ``dtype``: the net's
    (float32, as the JAX trainer's; float64 lets one step on the card be
    held to the CPU's at float64's precision, where a random-init
    BatchNorm net's gradient would amplify float32's rounding)."""

    def __init__(self, image_size: Tuple[int, int] = (256, 256),
                 lr: float = 1e-3, momentum: float = 0.9,
                 iou_threshold: float = 0.35, neg_pos_ratio: int = 7,
                 seed: int = 0, variables: Optional[dict] = None,
                 device="cuda", dtype: torch.dtype = torch.float32):
        from synergynet_tpu_torch.detect.detector import (
            BGR_MEAN, random_init_variables)
        self.device = resolve_device(device)
        self.image_size = image_size
        self.lr, self.momentum = lr, momentum
        self.iou_threshold, self.neg_pos_ratio = iou_threshold, neg_pos_ratio
        self.net = FaceBoxesNet(dtype=dtype, stem_s2d=False, folded=False)
        if variables is None:
            variables = random_init_variables(seed)
        self.net.load_state_dict(state_dict_from_flax(variables))
        self.net.to(self.device).train()
        self.state = TrainState(self.net)
        self.anchors = torch.tensor(generate_anchors(*image_size),
                                    device=self.device)
        self.mean = torch.tensor(BGR_MEAN, dtype=torch.float32,
                                 device=self.device)

    def step(self, images: torch.Tensor, gt_boxes: torch.Tensor,
             gt_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One SGD step on (B, H, W, 3) f32 BGR frames and their (B, G, 4)
        boxes and (B, G) mask, on the trainer's device; returns the losses
        as device tensors."""
        dev, st = self.device, self.state
        images, gt_boxes, gt_valid = (torch.as_tensor(x).to(dev)
                                      for x in (images, gt_boxes, gt_valid))
        with full_fp32():
            loc_t, labels = match(gt_boxes, gt_valid, self.anchors,
                                  self.iou_threshold)
            st.grads.zero_()
            loc, conf = self.net(images - self.mean)
            losses = multibox_loss(loc, conf, loc_t, labels,
                                   self.neg_pos_ratio)
            losses["loss_total"].backward()
        with torch.no_grad():
            st.trace.mul_(self.momentum).add_(st.grads)
            st.params.sub_(self.lr * (st.grads + self.momentum * st.trace))
            st.count.add_(1)
            st.step.add_(1)
        return {k: v.detach() for k, v in losses.items()}

    def train_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        losses = self.step(torch.from_numpy(batch["images"]),
                           torch.from_numpy(batch["boxes"]),
                           torch.from_numpy(batch["valid"]))
        return {k: float(v) for k, v in losses.items()}

    def fit_synthetic(self, steps: int = 50, batch: int = 8,
                      seed: int = 0, log_every: int = 10,
                      log_fn=None) -> list:
        rng = np.random.default_rng(seed)
        history = []
        for i in range(steps):
            losses = self.train_step(make_synthetic_detection_batch(
                rng, batch, self.image_size))
            history.append(losses)
            if log_fn and i % log_every == 0:
                log_fn(f"[det {i}] {losses}")
        return history

    @property
    def variables(self) -> dict:
        """``{"params", "batch_stats"}`` as flax-shaped numpy trees."""
        return flax_from_state_dict(self.net.state_dict())
