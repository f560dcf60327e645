"""Rendering for the overlay path: one-ring normals, Phong lighting, the
z-buffer kernels on triangle meshes (depth + payloads, depth + winning id)
with their record-based twins, the deferred-payload and visibility paths,
and the uint8 blend."""

from synergynet_tpu_torch.render.lighting import (  # noqa: F401
    OVERLAY_LIGHT_CFG, compute_vertex_light,
)
from synergynet_tpu_torch.render.normals import (  # noqa: F401
    get_normal_rings, one_ring_table,
)
from synergynet_tpu_torch.render.raster import DEPTH_INIT, blend_uint8  # noqa: F401
from synergynet_tpu_torch.render.raster_tiled import (  # noqa: F401
    compact_records, eval_deferred_payloads, payload_planes, plane_records,
    rasterize_buffers_reference, rasterize_buffers_tiled,
    rasterize_ids_reference, rasterize_mesh, rasterize_mesh_ids,
    rasterize_mesh_ids_reference, rasterize_records_reference,
    rasterize_triangles_tiled,
)
