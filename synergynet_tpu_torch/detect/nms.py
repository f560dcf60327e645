"""Greedy NMS keep-masks, batched, bit-identical to the sequential loop;
the reference-compatible NMS utilities.

Counterpart of ``synergynet_tpu/detect/nms.py``: ``greedy_nms_mask``
(``:31-71``), and ``nms_indices``, ``soft_nms_device`` and ``soft_nms``
(``:74-190``; here ``soft_nms`` runs ``soft_nms_device``). With boxes
sorted by score, box i is kept iff it is valid and no kept valid box j < i has
IoU >= threshold. The JAX package reaches that mask as the fixpoint of
``keep <- valid & ~(A @ keep > 0)``, ``A[i, j] = (iou >= t) & (j < i) &
valid[j]``, one matrix-vector product per step under a ``lax.while_loop``;
the fixpoint is unique and equal to the sequential greedy result, and it is
reached after (longest suppression chain + 1) steps.

:func:`greedy_nms_mask` launches kernel N1 (``csrc/nms_greedy.cu``) on a
CUDA tensor, or raises: the suppression bits of 64-box tiles, then one
tiled in-order walk per frame on the device, with no host read, so a CUDA
graph can capture it.
On a CPU tensor it runs the plain twin :func:`greedy_nms_mask_reference`:
the fixpoint on a bit-packed A, each row K/32 words of 32 suppression
bits, so a step is one AND over (..., K, K/32) words and a row reduction
(at K = 2048 and 128 frames, 134 MB instead of the 2 GB an fp32 A would
take). Eager PyTorch pays a host sync to test for the fixpoint, so the
test runs every ``_CHECK_EVERY`` steps; extra steps past the fixpoint
change nothing. :func:`greedy_nms_walk_reference` is N1's own algorithm in
plain PyTorch (:func:`suppression_rows` with N1's IoU test
:func:`iou_at_least`, in N1's layout :func:`n1_word_index`, then the tiled
walk), which the tests hold against both.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.ops.cuda_build import (check_tensor, launch,
                                                 require_sm90)

_WORD = 32
# Frames per block of the (frames, K, K) IoU temporaries in greedy_nms_mask.
_IOU_FRAMES = 8
# Fixpoint steps between host syncs (random-init detector frames settle in
# <= 16 steps).
_CHECK_EVERY = 8
# Kernel N1: tiles of 64 boxes and 64-bit suppression words, staged by its
# walk in chunks of up to 32 words a row (csrc/nms_greedy.cu).
N1_WORD = 64
N1_CHUNK = 32
N1_MAX_K = 16384
N1_MAX_FRAMES = 65535


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


def greedy_nms_mask_reference(boxes: torch.Tensor, valid: torch.Tensor,
                              iou_threshold: float = 0.3) -> torch.Tensor:
    """The plain twin of kernel N1, on any device: the bit-packed fixpoint
    (module docstring). Same contract as :func:`greedy_nms_mask`."""
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


def n1_layout(k: int):
    """(T, words a frame) of N1's suppression words at K = ``k``: T =
    ceil(K / 64) tiles, 64 T (T + 1) / 2 words of scratch a frame (the
    triangle of tiles t and words t <= w < T)."""
    nt = -(-k // N1_WORD)
    return nt, N1_WORD * nt * (nt + 1) // 2


def iou_at_least(a: torch.Tensor, b: torch.Tensor,
                 iou_threshold: float = 0.3) -> torch.Tensor:
    """N1's IoU test in plain PyTorch (``csrc/nms_greedy.cu``, "The IoU
    test"): corner boxes ``a`` (..., 4) and ``b`` (..., 4) f32, broadcast
    against each other -> bool, which equals ``IoU(a, b) >= threshold`` as
    :func:`pairwise_iou` computes it. Pairs of plain boxes (coordinates
    finite, |c| <= 2^60) at a threshold in [2^-126, 1] try the fast path:
    NaN-dropping min / max, and no division where ``p = thr * union`` is
    at least 2^-80 and ``inter`` is at least ``hi`` (true) or at most
    ``lo`` (false), the products of ``p`` with 1 +/- 2^-20; every other
    pair takes the twin's operations, the general path."""
    f32 = torch.float32
    thr = torch.tensor(iou_threshold, dtype=f32)
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    area_a = (ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0)
    area_b = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
    # The general path: pairwise_iou's operations, NaN-propagating.
    w = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + 1.0,
                    min=0.0)
    h = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + 1.0,
                    min=0.0)
    inter = w * h
    general = inter / (area_a + area_b - inter) >= thr
    # The fast path, as the kernel computes it.
    zero = torch.tensor(0.0, dtype=f32)
    w = torch.fmax(torch.fmin(ax2, bx2) - torch.fmax(ax1, bx1) + 1.0, zero)
    h = torch.fmax(torch.fmin(ay2, by2) - torch.fmax(ay1, by1) + 1.0, zero)
    inter = w * h
    p = thr * (area_a + area_b - inter)
    above = inter >= p * torch.tensor(1.0 + 2.0 ** -20, dtype=f32)
    below = inter <= p * torch.tensor(1.0 - 2.0 ** -20, dtype=f32)
    settled = (p >= torch.tensor(2.0 ** -80, dtype=f32)) & (above | below)
    thr32 = float(np.float32(iou_threshold))
    plain = (a.abs() <= 2.0 ** 60).all(-1) & (b.abs() <= 2.0 ** 60).all(-1)
    if not 2.0 ** -126 <= thr32 <= 1.0:
        plain = torch.zeros_like(plain)
    return torch.where(plain & settled, above, general)


def n1_word_index(valid: torch.Tensor) -> torch.Tensor:
    """(F, T, 64, T) position in N1's scratch (:func:`n1_layout`) of row i
    of tile t, word w, for F frames' (F, K) valid flags: tile t starts at
    64 (t T - t (t - 1) / 2) and holds W = LT - t + 1 words a row (LT the
    tile of the frame's last valid box), in chunks of up to 32 words, each
    chunk 64 rows x its width, row-major. Words the kernel does not write
    (w < t, w > LT) get the frame's word count, one past its last word."""
    f, k = valid.shape
    nt, cap = n1_layout(k)
    dev = valid.device
    last = (valid * torch.arange(1, k + 1, device=dev)).amax(-1) - 1
    lt = torch.div(last, N1_WORD, rounding_mode="floor")[:, None, None, None]
    t = torch.arange(nt, device=dev)[:, None, None]
    i = torch.arange(N1_WORD, device=dev)[None, :, None]
    w = torch.arange(nt, device=dev)[None, None, :]
    rel = (w - t).clamp(min=0)
    j = torch.div(rel, N1_CHUNK, rounding_mode="floor")
    width = torch.clamp(lt - t + 1 - j * N1_CHUNK, max=N1_CHUNK)
    base = N1_WORD * (t * nt - t * (t - 1) // 2)
    idx = base + N1_WORD * N1_CHUNK * j + i * width + rel - j * N1_CHUNK
    written = (w >= t) & (w <= lt)
    return torch.where(written, idx, cap).expand(f, nt, N1_WORD, nt)


def suppression_rows(boxes: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float = 0.3) -> torch.Tensor:
    """N1's first kernel in plain PyTorch: (F, K, 4) boxes + (F, K) valid
    -> (F, 64 T (T + 1) / 2) int64 words in N1's layout
    (:func:`n1_word_index`). Row r's word w holds bit c % 64 for every
    column c > r in word w with :func:`iou_at_least` (r, c), for valid r:
    the boxes that r suppresses once kept, the transpose of the fixpoint's
    A. Invalid rows are zero words, as the kernel writes them; words it
    does not write are zero here."""
    f, k = valid.shape
    nt, cap = n1_layout(k)
    dev = boxes.device
    shifts = torch.arange(N1_WORD, device=dev, dtype=torch.int64)
    cols = torch.arange(k, device=dev)
    dense = torch.zeros((f, nt * N1_WORD, nt), dtype=torch.int64,
                        device=dev)
    for r0 in range(0, k, 256):
        r1 = min(r0 + 256, k)
        bits = iou_at_least(boxes[:, r0:r1, None], boxes[:, None],
                            iou_threshold)
        bits &= cols > torch.arange(r0, r1, device=dev)[:, None]   # c > r
        bits &= valid[:, r0:r1, None]
        bits = torch.nn.functional.pad(bits, (0, nt * N1_WORD - k))
        # Distinct bits: the sum is their OR (bit 63 wraps to the sign).
        dense[:, r0:r1] = (bits.reshape(f, r1 - r0, nt, N1_WORD).to(
            torch.int64) << shifts).sum(-1)
    out = torch.zeros((f, cap + 1), dtype=torch.int64, device=dev)
    out.scatter_(1, n1_word_index(valid).reshape(f, -1),
                 dense.reshape(f, -1))
    return out[:, :cap]


def greedy_nms_walk_reference(boxes: torch.Tensor, valid: torch.Tensor,
                              iou_threshold: float = 0.3) -> torch.Tensor:
    """N1's algorithm in plain PyTorch, for the tests: (F, K, 4) boxes and
    (F, K) valid -> (F, K) keep. :func:`suppression_rows`, then per frame
    the tiled walk: a removed-mask word per tile, starting as the tile's
    invalid rows; for tile t, R = removed[t], and for i = 0 .. 63 in order,
    row i is kept iff bit i of R is clear, and then ORs its diagonal word
    into R; the kept rows' words right of the diagonal are ORed into the
    later tiles' removed words. T x 64 host steps and no host read; not a
    serving path."""
    f, k = valid.shape
    nt, cap = n1_layout(k)
    dev = boxes.device
    words = torch.nn.functional.pad(
        suppression_rows(boxes, valid, iou_threshold), (0, 1))
    tiles = torch.gather(words, 1, n1_word_index(valid).reshape(
        f, -1)).reshape(f, nt, N1_WORD, nt)
    shifts = torch.arange(N1_WORD, device=dev, dtype=torch.int64)
    vbits = torch.nn.functional.pad(valid, (0, nt * N1_WORD - k))
    vbits = (vbits.reshape(f, nt, N1_WORD).to(torch.int64) << shifts).sum(-1)
    removed = ~vbits
    later = torch.arange(nt, device=dev)
    keep = []
    for t in range(nt):
        r = removed[:, t]
        diag = tiles[:, t, :, t]
        for i in range(N1_WORD):
            r = r | torch.where(((r >> i) & 1) == 0, diag[:, i], 0)
        kept = (((~r)[:, None] >> shifts) & 1) == 1
        keep.append(kept)
        rows = torch.where(kept[:, :, None], tiles[:, t], 0)
        while rows.shape[1] > 1:                    # OR over the rows
            rows = rows[:, 0::2] | rows[:, 1::2]
        removed = removed | torch.where(later > t, rows[:, 0], 0)
    return torch.cat(keep, 1)[:, :k]


def _launch(boxes: torch.Tensor, valid: torch.Tensor,
            iou_threshold: float) -> torch.Tensor:
    """Check what N1 takes, allocate its scratch and output, launch on the
    current stream. Raises on anything else; never falls back. No host
    read and no synchronisation: safe under a CUDA graph capture."""
    dev = boxes.device
    f, k = valid.shape
    check_tensor("boxes", boxes, (torch.float32,), (f, k, 4), dev)
    check_tensor("valid", valid, (torch.bool,), (f, k), dev)
    if k > N1_MAX_K:
        raise ValueError(f"{k} candidates: kernel N1 takes at most "
                         f"{N1_MAX_K}")
    if f > N1_MAX_FRAMES:
        raise ValueError(f"{f} frames: kernel N1 takes at most "
                         f"{N1_MAX_FRAMES}")
    require_sm90(dev, "greedy-NMS")
    keep = torch.empty((f, k), dtype=torch.bool, device=dev)
    if keep.numel() == 0:
        return keep
    if boxes.data_ptr() % 16:            # the kernel reads boxes as float4
        boxes = boxes.clone()
    sup = torch.empty((f, n1_layout(k)[1]), dtype=torch.int64, device=dev)
    launch("nms_greedy", "synergy_nms_greedy",
           [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float], dev,
           boxes, valid, sup, keep, f, k, float(iou_threshold))
    return keep


def greedy_nms_mask(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float = 0.3) -> torch.Tensor:
    """Keep-mask of greedy NMS over score-sorted ``boxes`` (..., K, 4).

    ``valid`` (..., K) bool marks real (non-padding) candidates; padding is
    never kept and never suppresses. Leading dims are independent frames.
    On a CUDA tensor kernel N1 (f32 boxes, K <= ``N1_MAX_K``, or an
    error); on a CPU tensor the plain twin
    :func:`greedy_nms_mask_reference`.
    """
    lead, k = boxes.shape[:-2], boxes.shape[-2]
    if boxes.device.type == "cuda":
        keep = _launch(boxes.reshape(-1, k, 4), valid.reshape(-1, k),
                       iou_threshold)
        return keep.reshape(*lead, k)
    if boxes.device.type == "cpu":
        return greedy_nms_mask_reference(boxes, valid, iou_threshold)
    raise ValueError(f"no greedy NMS for device {boxes.device}")


def nms_indices(dets, iou_threshold: float = 0.3, device="cuda"):
    """Reference-compatible host API: (N, 5) [x1 y1 x2 y2 score] -> kept
    indices in descending-score order (reference nms_wrapper.py:13-19),
    the greedy mask computed on ``device`` (the card unless the caller asks
    for the CPU). Ties in score keep their input order."""
    dets = np.asarray(dets, np.float32).reshape(-1, 5)
    if not len(dets):
        return []
    order = np.argsort(-dets[:, 4], kind="stable")
    boxes = torch.from_numpy(dets[order, :4]).to(resolve_device(device))
    valid = torch.ones((dets.shape[0],), dtype=torch.bool,
                       device=boxes.device)
    keep = greedy_nms_mask(boxes, valid, iou_threshold).cpu().numpy()
    return [int(i) for i in order[keep]]


def soft_nms_device(boxes: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, sigma: float = 0.5,
                    iou_threshold: float = 0.3,
                    score_threshold: float = 0.001,
                    method: str = "gaussian"):
    """Soft-NMS over a fixed candidate budget on the inputs' device: boxes
    (K, 4), scores (K,), valid (K,) bool -> (pick_idx (K,) int32, pick_score
    (K,) f32, n_picked) with the first ``n_picked`` entries the kept
    candidates in pick order and their decayed scores; -1 and -inf past
    them.

    The reference's ``cpu_soft_nms`` (FaceBoxes/utils/nms/cpu_nms.pyx:
    70-163) as the JAX package's ``soft_nms_device`` runs it: the (K, K)
    IoU once, then K rounds of argmax pick (the first maximum), decay of
    the rest by the pick's IoU row (linear: 1 - IoU above the threshold;
    gaussian: exp(-IoU^2 / sigma); hard: 0 above the threshold), and the
    threshold discard of boxes that overlap the pick. Padding (``valid``
    false) is never picked. No round reads the host."""
    k = scores.shape[0]
    dev = scores.device
    neg = torch.tensor(float("-inf"), device=dev)
    iou = pairwise_iou(boxes.float())
    live = torch.where(valid, scores.float(), neg)
    idx = torch.full((k,), -1, dtype=torch.int32, device=dev)
    out = torch.full((k,), float("-inf"), device=dev)
    for i in range(k):
        j = torch.argmax(live)
        s = live[j]
        row = iou[j]
        if method == "linear":
            decay = torch.where(row > iou_threshold, 1.0 - row,
                                torch.ones_like(row))
        elif method == "gaussian":
            decay = torch.exp(-(row * row) / sigma)
        else:                                   # hard: ov > Nt -> 0
            decay = torch.where(row > iou_threshold, torch.zeros_like(row),
                                torch.ones_like(row))
        # -inf * 0 would be NaN: dead entries stay dead.
        new = torch.where(live > neg, live * decay, neg)
        # The reference discards below the threshold only inside its
        # positive-overlap branch (cpu_nms.pyx:128-158).
        new = torch.where((row > 0.0) & (new < score_threshold), neg, new)
        new[j] = neg
        picked = s > neg
        live = torch.where(picked, new, live)
        idx[i] = torch.where(picked, j.to(torch.int32),
                             torch.tensor(-1, dtype=torch.int32, device=dev))
        out[i] = s
    return idx, out, (out > neg).sum()


def soft_nms(dets, sigma: float = 0.5, iou_threshold: float = 0.3,
             score_threshold: float = 0.001, method: str = "gaussian",
             device="cuda") -> np.ndarray:
    """Soft-NMS (Bodla et al. 2017), the reference's host API
    (``cpu_soft_nms``, FaceBoxes/utils/nms/cpu_nms.pyx:70-163): (N, 5)
    [x1 y1 x2 y2 score] -> the kept detections (M, 5) in pick order with
    their decayed scores, numpy. Runs :func:`soft_nms_device` over all N
    boxes on ``device`` (the card unless the caller asks for the CPU)."""
    dets = np.asarray(dets, np.float32).reshape(-1, 5)
    t = torch.from_numpy(dets).to(resolve_device(device))
    valid = torch.ones((dets.shape[0],), dtype=torch.bool, device=t.device)
    idx, score, n = soft_nms_device(t[:, :4], t[:, 4], valid, sigma,
                                    iou_threshold, score_threshold, method)
    n = int(n)
    out = dets[idx[:n].cpu().numpy()]
    out[:, 4] = score[:n].cpu().numpy()
    return out
