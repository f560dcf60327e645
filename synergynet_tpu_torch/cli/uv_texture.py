"""Real-face UV-textured mesh CLI, the port's
``python -m synergynet_tpu_torch.cli.uv_texture`` (the reference's
``uv_texture_realFaces.py``).

Counterpart of ``synergynet_tpu/cli/uv_texture.py``, the reference flow
(uv_texture_realFaces.py:35-116): the images are pre-cropped 256x256
faces (the fixed roi [0, 0, 256, 256], no detector); regress the dense
vertices, trim to the face region, write a colored ``.obj`` from the
matching UV texture (``<tex_dir>/<name>_fake_B.png``), then render the
textured mesh over the input at alpha 0.6. The faces and the render run
on the card unless ``device="cpu"`` (``--platform cpu``) asks for the CPU:
:meth:`SynergyNet3DMM.get_all_outputs` (kernel B1 on the card) and the
textured :func:`~synergynet_tpu_torch.render.render_overlay` (kernel B2).
Images are read and written with cv2.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from synergynet_tpu_torch.cli.artistic import SKIN_BGR
from synergynet_tpu_torch.cli.infer import image_paths
from synergynet_tpu_torch.cli.train import PLATFORMS

RECT = [0.0, 0.0, 256.0, 256.0, 1.0]    # pre-cropped faces (reference :82)


def run(files: str, *, tex_dir: str = "texture_data/uv_real",
        out_dir: str = "inference_output", png: bool = False,
        api=None, uv_mapper=None, device="cuda") -> list:
    """Run the demo on ``files``; returns the written ``.obj`` paths."""
    from synergynet_tpu_torch.core.optional import import_cv2
    from synergynet_tpu_torch.pipeline import (SynergyNet3DMM,
                                               load_uv_assets,
                                               write_obj_with_colors)
    from synergynet_tpu_torch.render import (OVERLAY_LIGHT_CFG,
                                             RenderPipeline, render_overlay)

    cv2 = import_cv2("cli.uv_texture")
    api = api or SynergyNet3DMM(device=device)
    uv = uv_mapper or load_uv_assets()
    pipeline = RenderPipeline(device=api.device, **OVERLAY_LIGHT_CFG)
    os.makedirs(os.path.join(out_dir, "obj"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "rendering_overlay"), exist_ok=True)

    written = []
    for path in image_paths(files, png):
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            continue
        name = os.path.splitext(os.path.basename(path))[0]
        _, verts, _ = api.get_all_outputs(img, rects=[RECT],
                                          interpolation="linear")
        if not verts:
            continue

        tex_path = os.path.join(tex_dir, f"{name}_fake_B.png")
        if os.path.exists(tex_path):
            colors = uv.colors_from_texture(cv2.imread(tex_path, -1)[..., :3])
        else:
            colors = np.tile(np.asarray([SKIN_BGR], np.uint8),
                             (verts[0].shape[1], 1))

        v, c, tri = uv.trim(verts[0], colors)
        wfp = os.path.join(out_dir, "obj", f"{name}.obj")
        write_obj_with_colors(wfp, v, tri, c.astype(np.float32))
        written.append(wfp)

        tex01 = c.astype(np.float32) / 255.0
        overlay, _ = render_overlay(img, [v], None, alpha=0.6,
                                    connectivity=tri - 1, texture=tex01,
                                    pipeline=pipeline)
        cv2.imwrite(os.path.join(out_dir, "rendering_overlay",
                                 f"{name}.jpg"), overlay)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description="UV-textured mesh export")
    p.add_argument("-f", "--files", required=True)
    p.add_argument("--png", action="store_true")
    p.add_argument("--tex-dir", default="texture_data/uv_real")
    p.add_argument("--out-dir", default="inference_output")
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="device to run on (default: the CUDA card)")
    args = p.parse_args(argv)
    written = run(args.files, tex_dir=args.tex_dir, out_dir=args.out_dir,
                  png=args.png, device=PLATFORMS[args.platform or "cuda"])
    for w in written:
        print("wrote", w)
    return written


if __name__ == "__main__":
    main()
