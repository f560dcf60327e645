"""Import FaceBoxes PyTorch weights into the flax-layout detector tree.

Counterpart of ``synergynet_tpu/detect/torch_import.py``. The reference
ships a trained detector checkpoint (``FaceBoxes/weights/FaceBoxesProd.pth``,
a plain ``state_dict``, loaded with a ``module.`` prefix strip).
:func:`convert_torch_state_dict` turns it into the unfolded FaceBoxesNet
tree of the JAX package (conv weights OIHW -> HWIO, BatchNorm split into
params ``scale``/``bias`` and batch_stats ``mean``/``var``), as numpy
arrays; :class:`~synergynet_tpu_torch.detect.detector.FaceBoxes` folds and
converts it to the topology it runs. The trees save and load as flat
``.npz`` files (:func:`save_variables_npz`, :func:`load_variables_npz`),
readable by the JAX package's loader too.

:func:`load_faceboxes_variables` resolves a detector's weights: an
explicit ``.npz`` or ``.pth``, otherwise the detector's default weights.
Unlike the JAX loader it writes no conversion cache into the package.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# torch module path -> flax module path of the heads.
_HEAD_MAP = {"loc.0": "loc0", "loc.1": "loc1", "loc.2": "loc2",
             "conf.0": "conf0", "conf.1": "conf1", "conf.2": "conf2"}


def _put(tree: dict, path, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def convert_torch_state_dict(sd: Dict[str, "np.ndarray"]) -> dict:
    """A reference FaceBoxes state_dict (tensors or arrays, ``module.``
    prefixes allowed) -> ``{"params": ..., "batch_stats": ...}`` of numpy
    arrays in the JAX package's layout; ``num_batches_tracked`` is
    dropped."""
    params: dict = {}
    stats: dict = {}
    for name, val in sd.items():
        name = name.removeprefix("module.")
        arr = np.asarray(val.detach().cpu().numpy()
                         if hasattr(val, "detach") else val)
        parts = name.split(".")
        if parts[0] in ("loc", "conf"):
            mod = _HEAD_MAP[".".join(parts[:2])]
            if parts[2] == "weight":
                _put(params, (mod, "kernel"), arr.transpose(2, 3, 1, 0))
            else:
                _put(params, (mod, "bias"), arr)
            continue
        # conv1.conv.weight / inception1.branch3x3.bn.running_mean / ...
        mod, leaf = tuple(parts[:-1]), parts[-1]
        if leaf == "weight" and parts[-2] == "conv":
            _put(params, mod + ("kernel",), arr.transpose(2, 3, 1, 0))
        elif leaf == "weight" and parts[-2] == "bn":
            _put(params, mod + ("scale",), arr)
        elif leaf == "bias" and parts[-2] == "bn":
            _put(params, mod + ("bias",), arr)
        elif leaf == "running_mean":
            _put(stats, mod + ("mean",), arr)
        elif leaf == "running_var":
            _put(stats, mod + ("var",), arr)
    return {"params": params, "batch_stats": stats}


def expected_torch_shapes() -> Dict[str, tuple]:
    """The reference FaceBoxes state_dict's names and shapes (every conv's
    OIHW weight, its BatchNorm's four leaves and ``num_batches_tracked``,
    the heads' weights and biases): what a ``FaceBoxesProd.pth`` holds."""
    from synergynet_tpu_torch.detect.detector import BN_CONVS, HEADS
    out: Dict[str, tuple] = {}
    for name, kh, kw, cin, cout in BN_CONVS:
        t = name.replace("/", ".")
        out[f"{t}.conv.weight"] = (cout, cin, kh, kw)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{t}.bn.{leaf}"] = (cout,)
        out[f"{t}.bn.num_batches_tracked"] = ()
    for name, cin, cout in HEADS:
        t = f"{name[:-1]}.{name[-1]}"          # loc0 -> loc.0
        out[f"{t}.weight"] = (cout, cin, 3, 3)
        out[f"{t}.bias"] = (cout,)
    return out


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def save_variables_npz(path: str, variables: dict) -> None:
    """A nested tree -> one compressed ``.npz`` of ``a/b/leaf`` arrays."""
    np.savez_compressed(path, **dict(_flatten(variables)))


def load_variables_npz(path: str) -> dict:
    """A ``.npz`` of ``a/b/leaf`` arrays -> the nested tree of numpy
    arrays."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            _put(tree, key.split("/"), z[key])
    return tree


def load_faceboxes_variables(weights_path: Optional[str] = None,
                             seed: int = 0) -> dict:
    """A detector tree: from ``weights_path`` when given (an ``.npz`` of a
    tree, or a reference ``.pth`` state_dict, read with ``torch.load``'s
    default ``weights_only=True`` as the JAX loader reads it), else the
    detector's default weights for ``seed``
    (:func:`synergynet_tpu_torch.detect.detector.default_variables`)."""
    if weights_path is None:
        from synergynet_tpu_torch.detect.detector import default_variables
        return default_variables(seed)
    if weights_path.endswith(".npz"):
        return load_variables_npz(weights_path)
    import torch
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    return convert_torch_state_dict(sd)


# The stem BatchNorm's running variance in a seeded state dict, against
# the unit variance of the other layers: it scales the mean-subtracted
# pixels (deviation ~70) down as a trained net's statistics do, so the
# scores spread over (0, 1) without saturating at 1.
STEM_RUNNING_VAR = 40.0


def seeded_faceboxes_state_dict(seed: int) -> dict:
    """A complete reference-layout FaceBoxes state_dict (the names and
    shapes of :func:`expected_torch_shapes`) drawn from
    ``numpy.random.default_rng(seed)`` as
    :func:`~synergynet_tpu_torch.nn.torch_import.seeded_torch_state_dict`
    draws, with conv1's BatchNorm running variance scaled by
    :data:`STEM_RUNNING_VAR`: weights for tests and smoke runs without the
    released ``FaceBoxesProd.pth``."""
    from synergynet_tpu_torch.nn.torch_import import seeded_torch_state_dict
    sd = seeded_torch_state_dict(expected_torch_shapes(), seed)
    sd["conv1.bn.running_var"] *= STEM_RUNNING_VAR
    return sd
