"""Artistic-face colored-mesh CLI, the port's
``python -m synergynet_tpu_torch.cli.artistic`` (the reference's
``artistic.py``).

Counterpart of ``synergynet_tpu/cli/artistic.py``, the reference flow
(artistic.py:33-117): detect the faces, regress the dense vertices, look
up per-vertex colors in a UV-space texture (the BFM_UV mapping), trim to
the face region (keptInd / deletedTri) and write a colored ``.obj``.
Textures are ``<uv_dir>/<name>_fake_B.png`` as in the reference's
``uv_art/``; without one, a flat skin tone. The faces run on the card
unless ``device="cpu"`` (``--platform cpu``) asks for the CPU; images are
read with cv2.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from synergynet_tpu_torch.cli.infer import image_paths
from synergynet_tpu_torch.cli.train import PLATFORMS

SKIN_BGR = (140, 160, 205)      # the flat tone without a texture


def run(files: str, *, uv_dir: str = "uv_art",
        out_dir: str = "inference_output/obj", png: bool = False,
        api=None, uv_mapper=None, device="cuda") -> list:
    """Run the demo on ``files``; returns the written ``.obj`` paths."""
    from synergynet_tpu_torch.core.optional import import_cv2
    from synergynet_tpu_torch.pipeline import (SynergyNet3DMM,
                                               load_uv_assets,
                                               write_obj_with_colors)

    cv2 = import_cv2("cli.artistic")
    api = api or SynergyNet3DMM(device=device)
    uv = uv_mapper or load_uv_assets()
    os.makedirs(out_dir, exist_ok=True)

    written = []
    for path in image_paths(files, png):
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            continue
        name = os.path.splitext(os.path.basename(path))[0]
        _, verts, _ = api.get_all_outputs(img, interpolation="linear")
        if not verts:
            continue

        tex_path = os.path.join(uv_dir, f"{name}_fake_B.png")
        if os.path.exists(tex_path):
            colors = uv.colors_from_texture(cv2.imread(tex_path, -1)[..., :3])
        else:
            colors = np.tile(np.asarray([SKIN_BGR], np.uint8),
                             (verts[0].shape[1], 1))

        v, c, tri = uv.trim(verts[0], colors)
        wfp = os.path.join(out_dir, f"{name}.obj")
        write_obj_with_colors(wfp, v, tri, c.astype(np.float32))
        written.append(wfp)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description="Artistic colored-mesh export")
    p.add_argument("-f", "--files", required=True)
    p.add_argument("--png", action="store_true")
    p.add_argument("--uv-dir", default="uv_art")
    p.add_argument("--out-dir", default="inference_output/obj")
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="device to run on (default: the CUDA card)")
    args = p.parse_args(argv)
    written = run(args.files, uv_dir=args.uv_dir, out_dir=args.out_dir,
                  png=args.png, device=PLATFORMS[args.platform or "cuda"])
    for w in written:
        print("wrote", w)
    return written


if __name__ == "__main__":
    main()
