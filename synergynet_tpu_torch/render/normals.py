"""Mesh normals: triangle cross products and their per-vertex sums.

Counterpart of ``synergynet_tpu/render/normals.py`` (reference
Sim3DR/lib/rasterize_kernel.cpp:88-215): per-triangle cross products,
summed into each vertex over a host-built table of its incident triangles
(:func:`one_ring_table`), then normalised. The lighting path's
:func:`get_normal` / :func:`get_normal_rings` normalise WITHOUT a guard:
vertices that belong to no triangle come out NaN, exactly as in the
reference and the JAX package; no triangle references them, so the NaNs
are inert. :func:`get_tri_normal` (normalised) and :func:`get_ver_normal`
guard the norm with 1e-6, as the reference does.

The JAX package's segment sum (``jax.ops.segment_sum``) becomes the
one-ring gather for any topology: ``index_add_`` adds with atomics on a
card, in no fixed order, so its normals would differ in the last bits
from call to call. The ring table fixes which triangles each vertex sums
(ascending, padded with a zero row), and a gather + sum reduces them the
same way on every call, so the normals are reproducible; they equal the
segment sum up to float addition order.

The functions take leading batch dimensions on the vertices, so the
overlay lights all faces of a frame in one call where the JAX package
vmaps.
"""

from __future__ import annotations

import numpy as np
import torch

_RING_CACHE: dict = {}


def _tri_cross(vertices: torch.Tensor, triangles: torch.Tensor
               ) -> torch.Tensor:
    """Unnormalised per-triangle normals. vertices (..., V, 3), triangles
    (T, 3) int -> (..., T, 3); counter-clockwise (p1-p0) x (p2-p0)."""
    p0 = vertices[..., triangles[:, 0], :]
    p1 = vertices[..., triangles[:, 1], :]
    p2 = vertices[..., triangles[:, 2], :]
    return torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)


def one_ring_table(triangles, num_vertices: int) -> torch.Tensor:
    """(T, 3) int triangles (numpy or a CPU tensor) -> (V, K) int32 CPU
    tensor of incident triangle ids per vertex, padded with T (a zero row is
    appended to the normals before gathering). Built on the host, cached by
    topology content."""
    tr = np.asarray(triangles)
    key = (tr.shape, int(num_vertices), hash(tr.tobytes()))
    hit = _RING_CACHE.get(key)
    if hit is not None:
        return hit
    flat_v = tr.reshape(-1)                       # (3T,) vertex ids
    flat_t = np.repeat(np.arange(tr.shape[0], dtype=np.int32), 3)
    order = np.argsort(flat_v, kind="stable")
    sv, st = flat_v[order], flat_t[order]
    starts = np.searchsorted(sv, np.arange(num_vertices + 1))
    counts = starts[1:] - starts[:-1]
    k = max(int(counts.max()) if len(counts) else 1, 1)
    rings = np.full((num_vertices, k), tr.shape[0], np.int32)
    slot = np.arange(len(sv)) - starts[:-1].repeat(counts)
    rings[sv, slot] = st
    table = torch.from_numpy(rings)
    _RING_CACHE[key] = table
    return table


def get_normal_rings(vertices: torch.Tensor, triangles: torch.Tensor,
                     rings: torch.Tensor) -> torch.Tensor:
    """Vertex normals (..., V, 3) of vertices (..., V, 3): the triangle
    normals gathered over ``rings`` (from :func:`one_ring_table` for the
    same topology, on the vertices' device), summed, and normalised
    unguarded."""
    tri_n = _tri_cross(vertices, triangles)
    pad = tri_n.new_zeros(tri_n.shape[:-2] + (1, 3))
    padded = torch.cat([tri_n, pad], dim=-2)
    acc = padded[..., rings, :].sum(dim=-2)       # (..., V, K, 3) -> (..., V, 3)
    det = torch.sqrt((acc * acc).sum(dim=-1, keepdim=True))
    return acc / det


def _rings_on(triangles: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """The one-ring table of ``triangles`` as int64 on their device."""
    return one_ring_table(triangles.cpu().numpy(), num_vertices).long().to(
        triangles.device)


def get_tri_normal(vertices: torch.Tensor, triangles: torch.Tensor,
                   normalize: bool = False) -> torch.Tensor:
    """Per-triangle normals (T, 3) of vertices (V, 3); ``normalize``
    divides by the norm guarded at 1e-6 (rasterize_kernel.cpp:110-113)."""
    n = _tri_cross(vertices, triangles)
    if normalize:
        det = torch.linalg.vector_norm(n, dim=1, keepdim=True)
        n = n / torch.clamp(det, min=1e-6)
    return n


def accumulate_vertex_normals(tri_normal: torch.Tensor,
                              triangles: torch.Tensor,
                              num_vertices: int) -> torch.Tensor:
    """Sum each triangle's normal (T, 3) into its three corner vertices ->
    (num_vertices, 3), in the ring table's fixed order."""
    rings = _rings_on(triangles, num_vertices)
    padded = torch.cat([tri_normal, tri_normal.new_zeros((1, 3))], dim=0)
    return padded[rings].sum(dim=1)


def get_ver_normal(tri_normal: torch.Tensor, triangles: torch.Tensor,
                   num_vertices: int) -> torch.Tensor:
    """Accumulate + guarded normalize (rasterize_kernel.cpp:125-153)."""
    acc = accumulate_vertex_normals(tri_normal, triangles, num_vertices)
    det = torch.linalg.vector_norm(acc, dim=1, keepdim=True)
    return acc / torch.clamp(det, min=1e-6)


def get_normal(vertices: torch.Tensor, triangles: torch.Tensor
               ) -> torch.Tensor:
    """The lighting path's vertex normals (V, 3) of vertices (V, 3) and any
    triangles (T, 3): :func:`get_normal_rings` over the topology's ring
    table (reference Sim3DR/Sim3DR.py:8-12 -> rasterize_kernel.cpp:
    158-215), unguarded."""
    return get_normal_rings(vertices, triangles,
                            _rings_on(triangles, vertices.shape[-2]))
