"""The system under test, built from a configuration through the program's
public constructors: nothing else of the program is reached from here.

The program receives the inputs only: the detector's and the regressor's
flax-layout trees and the 3DMM pack's arrays. It folds, converts, casts
and lays them out itself.
"""

from __future__ import annotations

import inspect

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The crop size of a program whose API takes none.
FIXED_CROP = 120


def build(cfg: dict, trees: dict, pack_arrays: dict, device):
    """-> the configuration's ``FusedFrameEngine`` on ``device``, given the
    configuration's crop size (``regressor.crop``). A program whose
    ``SynergyNet3DMM`` takes no ``crop`` serves ``FIXED_CROP`` only, and
    another size raises."""
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.mm3d.assets import pack_from_arrays
    from synergynet_tpu_torch.pipeline import (FusedFrameEngine,
                                               SynergyNet3DMM)
    crop = cfg["regressor"]["crop"]
    takes_crop = "crop" in inspect.signature(SynergyNet3DMM).parameters
    if not takes_crop and crop != FIXED_CROP:
        raise ValueError(f"the program crops at {FIXED_CROP} pixels only; "
                         f"the configuration asks for {crop}")
    dtype = DTYPES[cfg["dtype"]]
    det_cfg = cfg["detector"]
    det = FaceBoxes(variables=trees["detector"], dtype=dtype,
                    stem_r=det_cfg["stem_r"], stem_mode=det_cfg["stem_mode"],
                    device=device)
    api = SynergyNet3DMM(cfg["regressor"]["arch"], trees["regressor"],
                         pack_from_arrays(pack_arrays), det, dtype,
                         device=device,
                         **({"crop": crop} if takes_crop else {}))
    return FusedFrameEngine(api, detector=det, max_faces=cfg["max_faces"])


def overlay(engine, alpha: float):
    from synergynet_tpu_torch.pipeline import FusedOverlayEngine
    return FusedOverlayEngine(engine, alpha=alpha)


def space_to_depth(frames: torch.Tensor, r: int) -> torch.Tensor:
    """The packing ``process_batch`` takes beside its frames."""
    from synergynet_tpu_torch.detect.net import space_to_depth as s2d
    return s2d(frames, r).contiguous()


def prepare_frame(engine, img):
    from synergynet_tpu_torch.detect.detector import prepare_frame as prep
    return prep(img, engine.detector.stem_r, engine.api.device)
