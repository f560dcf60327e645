"""Export the JAX package's default FaceBoxes init into the port's data.

Without a converted reference checkpoint the JAX ``FaceBoxes()`` builds
flax's init from ``jax.random.PRNGKey(0)``
(``synergynet_tpu/detect/torch_import.py::random_init_variables``). The
PyTorch port cannot draw that init without JAX, so this script writes the
tree once, as flat ``collection/module/.../leaf`` float32 arrays, to
``synergynet_tpu_torch/assets/faceboxes_flax_seed0.npz``, which the port's
``load_faceboxes_variables`` reads. Run from the repository root:

    python scripts/export_faceboxes_seed0.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "synergynet_tpu_torch", "assets",
                   "faceboxes_flax_seed0.npz")


def main():
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from synergynet_tpu.detect.torch_import import random_init_variables

    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v, np.float32)

    walk(jax.device_get(random_init_variables(0)), ())
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **flat)
    print(f"wrote {len(flat)} leaves to {OUT}")


if __name__ == "__main__":
    main()
