"""Single/multi-image inference CLI, the port's
``python -m synergynet_tpu_torch.cli.infer`` (the reference's
``singleImage.py``).

Counterpart of ``synergynet_tpu/cli/infer.py``, the reference flow
(singleImage.py:20-118): detect the faces, crop and resize, regress the
62 parameters, decode the 68 landmarks, the dense mesh and the pose, then
write a lit mesh overlay (and its solid layer), a landmark plot, a pose-axis
drawing and the first face's mesh into ``out_dir/{rendering_overlay,
landmarks,poses,obj}``. The faces and the render run on the card unless
``device="cpu"`` (``--platform cpu``) asks for the CPU: the detector and
:meth:`SynergyNet3DMM.get_all_outputs` (kernel B1 on the card), then
:func:`~synergynet_tpu_torch.render.render_overlay` (kernel B2). Images
are read and written with cv2 and the landmarks drawn with matplotlib.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional

import numpy as np

from synergynet_tpu_torch.cli.train import PLATFORMS


def image_paths(files: str, png: bool) -> list:
    """``files`` itself, or the sorted ``*.jpg`` (``*.png``) files in it
    when it is a directory."""
    if os.path.isdir(files):
        return sorted(glob.glob(os.path.join(files,
                                             "*.png" if png else "*.jpg")))
    return [files]


def load_variables(checkpoint: Optional[str]):
    """``--checkpoint`` -> ``SynergyNet3DMM``'s ``variables``: None (the
    seeded init), ``"trained"`` (the shipped weights), an exported
    ``.npz`` asset, or a reference MobileNetV2 ``.pth.tar``."""
    if checkpoint is None or checkpoint == "trained":
        return checkpoint
    if checkpoint.endswith(".npz"):
        from synergynet_tpu_torch.core.checkpoint import \
            load_trained_variables
        return load_trained_variables(checkpoint)
    from synergynet_tpu_torch.nn.torch_import import \
        load_synergynet_variables
    return load_synergynet_variables(checkpoint)


def run(files: str, *, out_dir: str = "inference_output",
        png: bool = False, alpha: float = 0.6,
        interpolation: str = "linear",
        checkpoint: Optional[str] = None,
        api=None, device="cuda") -> dict:
    """Run the demo on ``files``; returns ``{name: {"faces": n, "poses":
    [...]}}`` per image read."""
    from synergynet_tpu_torch.core.optional import import_cv2
    from synergynet_tpu_torch.mm3d import load_param_pack
    from synergynet_tpu_torch.pipeline import (SynergyNet3DMM, draw_axis,
                                               draw_landmarks, write_obj)
    from synergynet_tpu_torch.render import (OVERLAY_LIGHT_CFG,
                                             RenderPipeline, render_overlay)

    cv2 = import_cv2("cli.infer")
    if api is None:
        api = SynergyNet3DMM(variables=load_variables(checkpoint),
                             device=device)
    pipeline = RenderPipeline(device=api.device, **OVERLAY_LIGHT_CFG)
    tri = load_param_pack().tri.numpy()
    tri_1based = tri + 1

    for sub in ("rendering_overlay", "landmarks", "poses", "obj"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    results = {}
    for path in image_paths(files, png):
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            continue
        name = os.path.splitext(os.path.basename(path))[0]
        pts, verts, poses = api.get_all_outputs(
            img, interpolation=interpolation)
        results[name] = {"faces": len(pts), "poses": poses}
        if not pts:
            continue

        overlay, solid = render_overlay(img, verts, tri, alpha=alpha,
                                        pipeline=pipeline)
        wfp = os.path.join(out_dir, "rendering_overlay", f"{name}.jpg")
        cv2.imwrite(wfp[:-4] + "_solid.png", solid)
        cv2.imwrite(wfp, overlay)

        draw_landmarks(img, pts,
                       os.path.join(out_dir, "landmarks", f"{name}.jpg"))

        img_axis = img.copy()
        for lmk, (angles, _t3d) in zip(pts, poses):
            draw_axis(img_axis, angles[1], angles[0], angles[2], lmk)
        cv2.imwrite(os.path.join(out_dir, "poses", f"{name}.jpg"), img_axis)

        write_obj(os.path.join(out_dir, "obj", name), verts[0], tri_1based)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description="SynergyNet inference (PyTorch)")
    p.add_argument("-f", "--files", required=True,
                   help="image file or directory")
    p.add_argument("--png", action="store_true")
    p.add_argument("--out-dir", default="inference_output")
    p.add_argument("--alpha", type=float, default=0.6)
    p.add_argument("--checkpoint", default=None,
                   help="exported .npz, reference .pth.tar, or the "
                        "literal 'trained' for the shipped full-recipe "
                        "weights")
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="device to run on (default: the CUDA card)")
    args = p.parse_args(argv)
    r = run(args.files, out_dir=args.out_dir, png=args.png,
            alpha=args.alpha, checkpoint=args.checkpoint,
            device=PLATFORMS[args.platform or "cuda"])
    for name, info in r.items():
        print(f"{name}: {info['faces']} face(s)")
    return r


if __name__ == "__main__":
    main()
