"""The comparison that decides ``correct``: served faces against the
float32 reference, as numbers beside their limits.

The served faces of a frame come as a dict of tensors in canvas pixels:
``n`` real faces, then per face slot its ``rois`` (4,) and ``param``
(62,) as the serving engine's batch output gives them, and ``lmk``
(3, 68), ``dense`` (3, V), ``angles`` (3,) degrees and ``t3d`` (3,) as
the entry returned them. Each stage is judged on its own served input,
as a served model's tokens are judged on the served prefix: a crop one
pixel over is another image on a noise frame, a bf16 box rounds to other
pixels than a float32 one, and a random regressor's small errors move a
degenerate camera's angles far, so an end-to-end comparison would read
the noise of one stage as the fault of the next. The judge runs the
reference detector on the same canvases (every anchor), then, face by
face in served order:

1. detection: matches the face to a reference candidate, among those
   whose square roi lies within ``ROI_TOL`` of the served roi (a pixel
   and a share of the candidate's anchor size: a box's error is its loc
   error times a tenth of the anchor, and a bf16 detector's loc errors
   reach 0.25 on the 512-pixel anchors) the one of highest logit, else
   the nearest; ``roi_err`` is the served roi's distance from it beyond
   the one pixel that the integer half side may move, over the anchor
   size;
2. selection: a greedy walk forced along the served picks. At pick j,
   the best reference logit among the candidates that the served path
   could not have missed (no earlier pick suppresses them within
   ``IOU_BAND`` of IoU margin, their score is above the visibility
   threshold, their centre lies inside the frame by the roi tolerance),
   less the logit of the matched pick (or its distance below the
   visibility threshold), logits clipped where the float32 score the
   served path ranks by reaches 1 (``Z_SAT``: above it, candidates tie
   and go in anchor order); a face the reference keeps and the entry left
   out counts its whole logit, a pick that an earlier one suppresses by
   more than the band counts ``VIOLATION``: ``logit_gap``. Scores of a
   bf16 detector on noise lie close together, so a near tie reads as a
   small number, not as another face;
3. crop + regress: the reference's crop and regressor on the served roi
   against the served parameters, the L2 error of the 62 over the
   reference's L2 norm (the largest single error reads the tail of a
   drawn regressor's outputs, which on some crops reach tens of training
   deviations): ``param_err``;
4. decode: the reference's decode of the served parameters at the served
   roi against the served landmarks, dense vertices and t3d, over the
   larger of the roi's side and the mesh's extent: ``geom_err``; and the
   pose angles in degrees: ``pose_err``, over the faces whose camera rows
   stand at least 30 degrees from parallel (``POSE_CONDITION``: the Euler
   angles of a degenerate camera are undefined, and a random regressor
   gives such cameras);
5. where the entry returns an overlay, the reference renders the served
   meshes into the same frame (``perfbench.reference.render``, scaled
   back to the frame's size as served): ``overlay_err``, the share in %
   of the pixels it draws at which the served overlay differs from its
   by more than ``OVERLAY_LEVELS`` in a channel.

Each number is the maximum over every judged face (frame, for the
overlay).
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import pipeline as P
from perfbench.reference.precision import Precision, exact_f32

IOU_BAND = 0.1
# The logit above which a float32 softmax score is exactly 1 (-ln 2^-24):
# the program ranks by that score, so candidates above it tie and the
# stable sort takes the lower index; the walk compares logits clipped here.
Z_SAT = 16.6355
POSE_CONDITION = 0.5
ROI_TOL = (1.0, 0.05)            # pixels + share of the anchor's size
OVERLAY_LEVELS = 2
VIOLATION = 100.0
FRAME_CHUNK = 16


def _gap(logit, boxes, valid, m, n):
    """Forced greedy walk: (B, K) logits, boxes, flags of the reference
    candidates the served path could not have missed; (B, F) matched
    picks; (B,) served counts -> the worst gap over picks and frames."""
    b, f = m.shape
    rows = torch.arange(b, device=m.device)
    logit = logit.clamp(max=Z_SAT)
    worst = torch.zeros(b, device=logit.device)
    maxiou = torch.zeros_like(logit)
    picked = torch.zeros_like(valid)
    for j in range(f):
        avail = valid & ~picked & (maxiou < P.NMS_T - IOU_BAND) & (logit > 0)
        best = torch.where(avail, logit, torch.full_like(logit, -1e30)
                           ).amax(-1)
        pj = m[:, j]
        zj = logit[rows, pj]
        allowed = maxiou[rows, pj] <= P.NMS_T + IOU_BAND
        served = j < n
        gap = torch.where(
            served,
            torch.where(allowed,
                        torch.maximum(best - zj, -zj).clamp(min=0),
                        torch.full_like(zj, VIOLATION)),
            best.clamp(min=0))
        worst = torch.maximum(worst, gap)
        sel = served[:, None] & (torch.arange(logit.shape[1],
                                              device=m.device) == pj[:, None])
        picked |= sel
        ov = P.iou(boxes, boxes[rows, pj][:, None])[..., 0]   # (B, K)
        maxiou = torch.where(served[:, None], torch.maximum(maxiou, ov),
                             maxiou)
    return worst.amax().item() if b else 0.0


def _wrap(deg):
    return (deg + 180.0) % 360.0 - 180.0


def judge(regressor: dict, det: dict, reg: dict, pack: dict,
          canvas: torch.Tensor, true_hw: torch.Tensor,
          faces: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers for served ``faces`` of (B, 720, 1088, 3) canvases;
    ``regressor`` is the configuration's regressor entry (its ``arch``
    and ``crop``), ``reg`` its tree."""
    p = Precision("f32")
    anc = P.anchors(canvas.shape[1], canvas.shape[2], canvas.device)
    out = {"logit_gap": 0.0, "roi_err": 0.0, "param_err": 0.0,
           "geom_err": 0.0, "pose_err": 0.0}
    with exact_f32(), torch.no_grad():
        if "overlay" in faces:
            out["overlay_err"] = overlay_err(p, pack, canvas, true_hw, faces)
        for f0 in range(0, canvas.shape[0], FRAME_CHUNK):
            sl = slice(f0, f0 + FRAME_CHUNK)
            part = {k: v[sl] for k, v in faces.items()
                    if k in ("n", "rois", "param", "lmk", "dense", "angles",
                             "t3d")}
            for k, v in _judge_frames(p, regressor, det, reg, pack,
                                      canvas[sl], true_hw[sl], part,
                                      anc).items():
                out[k] = max(out[k], v)
    return out


def overlay_err(p, pack, canvas, true_hw, faces) -> float:
    """The overlay number (module doc) over every served frame."""
    from perfbench.reference.render import as_served, overlay
    bad = drawn = 0
    for i, served in enumerate(faces["overlay"]):
        n = int(faces["n"][i])
        ref, counts = overlay(p, canvas[i], faces["dense"][i, :n],
                              pack["tri"], faces["alpha"])
        ref = as_served(ref, true_hw[i].tolist(), served.shape[:2])
        diff = (served.int() - ref.int()).abs().amax(-1)
        bad += int((diff > OVERLAY_LEVELS).sum())
        drawn += counts["drawn"]
    return 100.0 * bad / max(drawn, 1)


def _judge_frames(p, regressor, det, reg, pack, canvas, true_hw, faces,
                  anc):
    c = P.candidates(p, det, canvas, true_hw, anc)
    logit, boxes, valid = c["logit"], c["boxes"], c["valid"]
    rois = P.square_rois(boxes)
    n = faces["n"].long()
    f = faces["lmk"].shape[1]
    b = canvas.shape[0]
    rows = torch.arange(b, device=canvas.device)[:, None]
    served_rois = faces["rois"]
    side = (served_rois[..., 2] - served_rois[..., 0]).abs().clamp(min=1.0)
    anchor = (anc[:, 2:] * torch.tensor(canvas.shape[1:3][::-1],
                                        device=anc.device)).amax(-1)
    tol = ROI_TOL[0] + ROI_TOL[1] * anchor                   # (A,)
    d = (served_rois[:, :, None] - rois[:, None]).abs().amax(-1)
    near = d <= tol
    m = torch.where(near.any(-1),
                    torch.where(near, logit[:, None], torch.full_like(
                        d, -float("inf"))).argmax(-1), d.argmin(-1))
    centre = (boxes[..., :2] + boxes[..., 2:]) / 2
    inside = ((centre[..., 0] < true_hw[:, 1:2] - tol)
              & (centre[..., 1] < true_hw[:, 0:1] - tol))
    served = torch.arange(f, device=m.device)[None] < n[:, None]
    zero = torch.zeros(b, f, device=canvas.device)

    def worst(x):
        return torch.where(served, x, zero).amax().item()

    roi = ((served_rois - rois[rows, m]).abs() - 1).clamp(min=0).amax(-1)
    roi = roi / anchor[m]
    param = P.regress(p, regressor, reg, canvas, served_rois)
    perr = (faces["param"] - param).norm(dim=-1) / param.norm(dim=-1)
    geom, pose = zero.clone(), zero.clone()
    for i in range(b):
        lmk, dense, angles, t3d = P.decode(p, pack, faces["param"][i],
                                           served_rois[i])
        extent = (dense.amax(-1) - dense.amin(-1)).amax(-1)
        errs = [(faces["lmk"][i] - lmk).abs().flatten(1).amax(-1),
                (faces["dense"][i] - dense).abs().flatten(1).amax(-1),
                (faces["t3d"][i, :, :2] - t3d[:, :2]).abs().amax(-1)]
        geom[i] = torch.stack(errs).amax(0) / torch.maximum(side[i], extent)
        pose[i] = _wrap(faces["angles"][i] - angles).abs().amax(-1)
    raw = faces["param"] * pack["param_std"] + pack["param_mean"]
    cam = raw[..., :8].reshape(b, f, 2, 4)[..., :3]
    cam = cam / cam.norm(dim=-1, keepdim=True)
    posed = torch.linalg.cross(cam[..., 0, :], cam[..., 1, :],
                               dim=-1).norm(dim=-1) >= POSE_CONDITION
    return {"logit_gap": _gap(logit, boxes, valid & inside, m, n),
            "roi_err": worst(roi), "param_err": worst(perr),
            "geom_err": worst(geom),
            "pose_err": worst(torch.where(posed, pose, zero))}
