"""Kernel B2's share of its roofline, %: the least time of the z-buffer
raster of the frame's meshes in B2's mesh form (``perfbench.counts.raster``
on the fragments and drawn pixels of the served meshes of the ring's
frames, float32 operations) over the trace's B2 time per frame
(``fill_keys``, ``raster_mesh_kernel`` and ``resolve_mesh_kernel``)."""

from perfbench.counts import raster
from perfbench.peaks import F32_FLOPS, bound
from perfbench.tracing import op_seconds


def read(rec):
    parts = [op_seconds(rec.trace, f) for f in
             ("fill_keys", "raster_mesh_kernel", "resolve_mesh_kernel")]
    work = rec.inputs.get("raster")
    if not work or any(t is None for t in parts):
        return None
    b = sum(bound(*raster.work(r["nver"], r["ntri"], 3, r["frags"],
                               r["drawn"], r["h"], r["w"], 4),
                  F32_FLOPS)[0] for r in work) / len(work)
    return 100.0 * b / sum(parts)
