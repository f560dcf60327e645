"""AFLW2000-3D benchmark pipeline: params extraction -> NME + FOE reports.

Counterpart of ``synergynet_tpu/evals/benchmark.py`` (reference
``benchmark.py`` :99-239 and ``benchmark_validate.benchmark_pipeline``
:243-266): the model extracts 62-d parameters over the dataset in
fixed-size batches on its device, landmarks decode in the port's codec,
and the NME/FOE math is :mod:`synergynet_tpu_torch.evals.nme` /
:mod:`synergynet_tpu_torch.evals.foe`.

Protocol notes kept: eval normalization is (x - 127.5) / std with std=128
standalone vs 130 in-training (quirk Q6, default 128); the border zeroing
is CenterCrop mode='test' (benchmark.py:117); pose MAE skips |yaw| > 99
samples and swaps the first two decoded angles (benchmark.py:199-207).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from synergynet_tpu_torch.evals.foe import foe_mae, format_foe_report
from synergynet_tpu_torch.evals.nme import (analyze_by_yaw, calc_nme,
                                            format_nme_report)
from synergynet_tpu_torch.mm3d import (ParamPack, decode_landmarks,
                                       load_param_pack, pose_from_param)
from synergynet_tpu_torch.mm3d.codec import full_fp32_if


def make_param_extractor(model: torch.nn.Module, *, std: float = 128.0,
                         batch: int = 128) -> Callable[[np.ndarray],
                                                       np.ndarray]:
    """Returns ``extract(images_u8 (N, 120, 120, 3)) -> (N, 62)``: the
    model in eval mode on its own device, in fixed-size batches (the last
    one zero-padded, then trimmed), the model's train/eval mode restored
    after. An f32 model (``model.dtype``, f32 when it has none) runs in
    full f32, TF32 off, as the JAX package's extractor computes."""
    dev = next(model.parameters()).device
    dtype = getattr(model, "dtype", torch.float32)

    def extract(images_u8: np.ndarray) -> np.ndarray:
        n = images_u8.shape[0]
        out = []
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad(), full_fp32_if(dtype):
                for s in range(0, n, batch):
                    chunk = images_u8[s:s + batch]
                    pad = batch - chunk.shape[0]
                    if pad:
                        chunk = np.concatenate([chunk, np.zeros(
                            (pad,) + chunk.shape[1:], chunk.dtype)])
                    x = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
                    x = (x.float() - 127.5) / std
                    p62, _ = model(x)
                    out.append(p62.float().cpu().numpy()[:batch - pad])
        finally:
            model.train(was_training)
        return np.concatenate(out) if out else np.zeros((0, 62), np.float32)

    return extract


def benchmark_params(params: np.ndarray, eval_pack: Dict[str, np.ndarray],
                     pack: Optional[ParamPack] = None) -> Dict:
    """Score (N, 62) params against an AFLW2000-protocol eval pack (keys:
    pts68_gt, roi_boxes, yaws, pose_gt_pyr, skip_indices); the decode runs
    on the CPU in fp32."""
    pack = pack or load_param_pack()
    p = torch.from_numpy(np.asarray(params, np.float32))
    with torch.no_grad():
        lmk = decode_landmarks(p, pack).numpy()
    nme = calc_nme(lmk, eval_pack["pts68_gt"], eval_pack["roi_boxes"])
    analysis = analyze_by_yaw(nme, eval_pack["yaws"])
    report = format_nme_report(analysis)
    foe = None
    if eval_pack.get("pose_gt_pyr") is not None:
        with torch.no_grad():
            angles, _ = pose_from_param(p, pack)
        foe = foe_mae(angles.numpy(), eval_pack["pose_gt_pyr"],
                      skip_indices=eval_pack.get("skip_indices"))
        report += "\n" + format_foe_report(foe)
    return {"nme": analysis, "nme_mean": analysis["mean_of_means"],
            "foe": foe, "report": report}


def benchmark_pipeline(model: torch.nn.Module,
                       eval_pack: Dict[str, np.ndarray],
                       pack: Optional[ParamPack] = None, *,
                       std: float = 128.0, batch: int = 128,
                       transform=None) -> Dict:
    """Full eval: images -> params -> NME/FOE dict (the in-training
    validation hook, reference benchmark_validate.py:243-266)."""
    images = eval_pack["images"]
    if transform is not None:
        images = np.stack([transform(im) for im in images])
    params = make_param_extractor(model, std=std, batch=batch)(images)
    return benchmark_params(params, eval_pack, pack)
