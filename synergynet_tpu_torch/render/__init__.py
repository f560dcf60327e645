"""Rendering: one-ring and segment normals, Phong lighting, the z-buffer
kernels on triangle meshes (depth + payloads, depth + winning id) with
their record-based twins, the deferred-payload and visibility paths, the
uint8 blend, and the host APIs (the reference's rasterizer, the lit
``RenderPipeline``, the mesh overlay and the UV texture render)."""

from synergynet_tpu_torch.render.lighting import (  # noqa: F401
    OVERLAY_LIGHT_CFG, RenderPipeline, compute_vertex_light,
)
from synergynet_tpu_torch.render.normals import (  # noqa: F401
    accumulate_vertex_normals, get_normal, get_normal_rings, get_tri_normal,
    get_ver_normal, one_ring_table,
)
from synergynet_tpu_torch.render.overlay import (  # noqa: F401
    add_weighted_u8, render_overlay,
)
from synergynet_tpu_torch.render.raster import (  # noqa: F401
    DEPTH_INIT, blend_uint8,
)
from synergynet_tpu_torch.render.raster_tiled import (  # noqa: F401
    compact_records, eval_deferred_payloads, payload_planes, plane_records,
    rasterize_buffers_reference, rasterize_buffers_tiled,
    rasterize, rasterize_buffers, rasterize_ids_reference, rasterize_mesh,
    rasterize_mesh_ids, rasterize_mesh_ids_reference,
    rasterize_records_reference, rasterize_tiled, rasterize_triangles,
    rasterize_triangles_tiled,
)
from synergynet_tpu_torch.render.texture import (  # noqa: F401
    rasterize_texture_buffers, render_texture,
)
