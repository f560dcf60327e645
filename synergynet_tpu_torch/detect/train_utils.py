"""Detector training: anchor matching, box encoding, the multibox loss.

Counterpart of ``synergynet_tpu/detect/train_utils.py`` (reference
FaceBoxes/utils/box_utils.py:98-173): matching is two argmaxes over the
IoU matrix, batched over any leading axes; hard-negative mining ranks the
background anchors by their loss with a stable ``argsort`` of a stable
``argsort``, so ties break as the JAX package's stable sort breaks them.

Anchors are (A, 4) ``[cx, cy, w, h]`` normalized; ground-truth boxes
(..., G, 4) corner form, normalized; variances (0.1, 0.2), as decode's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from synergynet_tpu_torch.detect.anchors import VARIANCES


def center_to_corner(boxes: torch.Tensor) -> torch.Tensor:
    tl = boxes[..., :2] - boxes[..., 2:] / 2
    return torch.cat([tl, tl + boxes[..., 2:]], dim=-1)


def jaccard(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., A, 4) x (..., B, 4) corner boxes -> (..., A, B) IoU (no +1:
    normalized coordinates)."""
    a, b = boxes_a[..., :, None, :], boxes_b[..., None, :, :]
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter)


def encode(matched: torch.Tensor, anchors: torch.Tensor,
           variances=VARIANCES) -> torch.Tensor:
    """Corner ground truth (..., A, 4) matched per anchor -> regression
    targets (..., A, 4), the inverse of decode."""
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2 - anchors[..., :2]
    g_cxcy = g_cxcy / (variances[0] * anchors[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / anchors[..., 2:]
    g_wh = torch.log(torch.clamp(g_wh, min=1e-8)) / variances[1]
    return torch.cat([g_cxcy, g_wh], dim=-1)


def match(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
          anchors: torch.Tensor, iou_threshold: float = 0.35
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign ground truth to anchors: every valid GT claims its best anchor
    (a sure positive); the other anchors take their best GT when its IoU
    reaches ``iou_threshold``. ``gt_boxes`` (..., G, 4), ``gt_valid``
    (..., G) bool (padded rows False). Returns (loc_targets (..., A, 4),
    labels (..., A) int32: 1 face, 0 background).

    Two GTs that claim one anchor: the later GT keeps it, as the JAX
    scatter's last write does on the CPU."""
    iou = jaccard(gt_boxes, center_to_corner(anchors))      # (..., G, A)
    iou = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
    best_anchor_per_gt = iou.argmax(dim=-1)                  # (..., G)
    best_gt_per_anchor = iou.argmax(dim=-2)                  # (..., A)
    best_iou_per_anchor = iou.amax(dim=-2)
    g = gt_boxes.shape[-2]
    gids = torch.arange(g, device=iou.device).expand_as(best_anchor_per_gt)
    # An invalid row claims nothing: it writes -1 into an extra slot.
    claim_idx = torch.where(gt_valid, best_anchor_per_gt,
                            torch.full_like(best_anchor_per_gt,
                                            anchors.shape[0]))
    gt_of_claim = torch.full(iou.shape[:-2] + (anchors.shape[0] + 1,), -1,
                             dtype=torch.long, device=iou.device)
    gt_of_claim = gt_of_claim.scatter_reduce(-1, claim_idx, gids, "amax")
    gt_of_claim = gt_of_claim[..., :-1]
    claimed = gt_of_claim >= 0
    assigned = torch.where(claimed, gt_of_claim, best_gt_per_anchor)
    positive = claimed | (best_iou_per_anchor >= iou_threshold)
    matched = torch.gather(gt_boxes, -2, assigned[..., None].expand(
        *assigned.shape, 4))
    return encode(matched, anchors), positive.to(torch.int32)


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def multibox_loss(loc_pred: torch.Tensor, conf_logits: torch.Tensor,
                  loc_t: torch.Tensor, labels: torch.Tensor,
                  neg_pos_ratio: int = 7) -> Dict[str, torch.Tensor]:
    """The SSD multibox objective with hard-negative mining, batched:
    ``loc_pred`` (B, A, 4), ``conf_logits`` (B, A, 2), ``loc_t`` (B, A, 4),
    ``labels`` (B, A) in {0, 1}. Each sample keeps its ``neg_pos_ratio`` x
    positives hardest background anchors (by confidence loss). Returns
    ``loss_loc``, ``loss_conf`` and ``loss_total`` (0-d tensors)."""
    pos = labels > 0
    n_pos = pos.sum(dim=1)
    loss_l = (smooth_l1(loc_pred - loc_t).sum(-1) * pos).sum(dim=1)
    logp = F.log_softmax(conf_logits, dim=-1)
    lab = labels.to(logp.dtype)
    ce = -logp[..., 0] * (1 - lab) - logp[..., 1] * lab          # (B, A)
    neg_loss = torch.where(pos, torch.full_like(ce, float("-inf")), ce)
    order = torch.argsort(-neg_loss, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    n_neg = torch.minimum(neg_pos_ratio * n_pos, (~pos).sum(dim=1))
    neg = rank < n_neg[:, None]
    loss_c = (ce * (pos | neg)).sum(dim=1)
    denom = torch.clamp(n_pos.to(torch.float32), min=1.0)
    return {"loss_loc": (loss_l / denom).mean(),
            "loss_conf": (loss_c / denom).mean(),
            "loss_total": ((loss_l + loss_c) / denom).mean()}
