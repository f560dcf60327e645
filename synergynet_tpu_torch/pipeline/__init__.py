"""Serving pipeline: the packaged two-stage API, the fused frame engine,
crops, mesh outputs, the overlay engine."""

from synergynet_tpu_torch.pipeline.api import (  # noqa: F401
    MAX_FACES_PER_BATCH, FusedFrameEngine, SynergyNet3DMM, prepare_frame,
    preprocess_crops, unpack_face_outputs,
)
from synergynet_tpu_torch.pipeline.device_crop import (  # noqa: F401
    crop_resize_bilinear, crop_resize_hybrid, crop_resize_matmul,
    square_rois,
)
from synergynet_tpu_torch.pipeline.outputs import (  # noqa: F401
    UVTextureMapper, load_uv_assets, write_obj, write_obj_with_colors,
    write_obj_with_colors_texture,
)
from synergynet_tpu_torch.pipeline.overlay_engine import (  # noqa: F401
    FusedOverlayEngine, render_lit_faces, render_lit_faces_adaptive,
)
