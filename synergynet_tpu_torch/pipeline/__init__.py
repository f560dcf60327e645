"""Serving pipeline: the regressor API, the fused frame engine, crops, the
overlay engine."""

from synergynet_tpu_torch.pipeline.api import (  # noqa: F401
    SynergyNet3DMM, FusedFrameEngine, prepare_frame, unpack_face_outputs,
)
from synergynet_tpu_torch.pipeline.device_crop import (  # noqa: F401
    crop_resize_matmul, square_rois,
)
from synergynet_tpu_torch.pipeline.overlay_engine import (  # noqa: F401
    FusedOverlayEngine, render_lit_faces, render_lit_faces_adaptive,
)
