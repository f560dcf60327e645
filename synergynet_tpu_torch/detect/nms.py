"""Greedy NMS keep-masks, batched, bit-identical to the sequential loop.

Counterpart of ``synergynet_tpu/detect/nms.py:31-71``. With boxes sorted by
score, box i is kept iff it is valid and no kept valid box j < i has
IoU >= threshold. The JAX package reaches that mask as the fixpoint of
``keep <- valid & ~(A @ keep > 0)``, ``A[i, j] = (iou >= t) & (j < i) &
valid[j]``, one matrix-vector product per step; the fixpoint is unique and
equal to the sequential greedy result, and it is reached after (longest
suppression chain + 1) steps.

Here the same iteration runs on a bit-packed A: each row is K/32 words of
32 suppression bits, so a step is one AND over (..., K, K/32) words and a
row reduction — at K = 2048 and 128 frames, 134 MB instead of the 2 GB an
fp32 A would take. Eager PyTorch pays a host sync to test for the
fixpoint, so the test runs every ``_CHECK_EVERY`` steps; extra steps past
the fixpoint change nothing.
"""

from __future__ import annotations

import torch

_WORD = 32
# Frames per block of the (frames, K, K) IoU temporaries in greedy_nms_mask.
_IOU_FRAMES = 8
# Fixpoint steps between host syncs (random-init detector frames settle in
# <= 16 steps).
_CHECK_EVERY = 8


def pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) corner boxes -> (..., K, K) IoU with the reference's +1
    pixel-inclusive areas."""
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = torch.clamp(xx2 - xx1 + 1.0, min=0.0)
    h = torch.clamp(yy2 - yy1 + 1.0, min=0.0)
    inter = w * h
    return inter / (area[..., :, None] + area[..., None, :] - inter)


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(..., n * 32) bool -> (..., n) int64 words holding 32 bits each."""
    shifts = torch.arange(_WORD, device=mask.device, dtype=torch.int64)
    words = mask.reshape(*mask.shape[:-1], -1, _WORD).to(torch.int64)
    return (words << shifts).sum(-1)


def greedy_nms_mask(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float = 0.3) -> torch.Tensor:
    """Keep-mask of greedy NMS over score-sorted ``boxes`` (..., K, 4).

    ``valid`` (..., K) bool marks real (non-padding) candidates; padding is
    never kept and never suppresses. Leading dims are independent frames.
    """
    lead, k = boxes.shape[:-2], boxes.shape[-2]
    boxes = boxes.reshape(-1, k, 4)
    valid = valid.reshape(-1, k)
    kw = -(-k // _WORD) * _WORD                     # columns padded to words
    lower = torch.tril(torch.ones((k, k), dtype=torch.bool,
                                  device=boxes.device), -1)        # j < i
    sup = torch.empty((boxes.shape[0], k, kw // _WORD), dtype=torch.int64,
                      device=boxes.device)
    for f0 in range(0, boxes.shape[0], _IOU_FRAMES):
        sl = slice(f0, f0 + _IOU_FRAMES)
        a = (pairwise_iou(boxes[sl]) >= iou_threshold) & lower
        a &= valid[sl, None, :]                     # only real j suppress
        sup[sl] = _pack_bits(torch.nn.functional.pad(a, (0, kw - k)))

    keep = valid
    for it in range(k):
        words = _pack_bits(torch.nn.functional.pad(keep, (0, kw - k)))
        hit = (sup & words[:, None, :]).ne(0).any(-1)
        new = valid & ~hit
        done = (it + 1) % _CHECK_EVERY == 0 and torch.equal(new, keep)
        keep = new
        if done:
            break
    return keep.reshape(*lead, k)
