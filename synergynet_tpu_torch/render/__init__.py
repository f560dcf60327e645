"""Rendering for the overlay path: one-ring normals, Phong lighting, the
z-buffer kernel on plane records and the uint8 blend."""

from synergynet_tpu_torch.render.lighting import (  # noqa: F401
    OVERLAY_LIGHT_CFG, compute_vertex_light,
)
from synergynet_tpu_torch.render.normals import (  # noqa: F401
    get_normal_rings, one_ring_table,
)
from synergynet_tpu_torch.render.raster import DEPTH_INIT, blend_uint8  # noqa: F401
from synergynet_tpu_torch.render.raster_tiled import (  # noqa: F401
    plane_records, rasterize_buffers_reference, rasterize_buffers_tiled,
    rasterize_records, rasterize_records_reference,
)
