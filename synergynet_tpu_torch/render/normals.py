"""Mesh vertex normals by one-ring gather, for a fixed topology.

Counterpart of the one-ring path of ``synergynet_tpu/render/normals.py``
(reference Sim3DR/lib/rasterize_kernel.cpp:158-215): per-triangle cross
products, summed into each vertex over a host-built table of its incident
triangles, then normalised WITHOUT a guard. Vertices that belong to no
triangle come out NaN, exactly as in the reference and the JAX package;
no triangle references them, so the NaNs are inert.

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
