"""The z-buffer raster of meshes (kernel B2's mesh form): read the
vertices, their payloads and the triangles, write the depth and payload
buffers; 53 operations to set up a triangle, 13 a pixel of its clamped
bounding box, and for each drawn pixel the winner's 41-operation setup
and 16 a payload."""

from __future__ import annotations


def work(nver, ntri, n_payload, frags, drawn, h, w, tri_bytes):
    """(bytes, operations)."""
    out = h * w * 4 * (1 + max(n_payload, 1))
    nbytes = 4 * nver * (3 + n_payload) + tri_bytes * 3 * ntri + out
    ops = 53 * ntri + 13 * frags + drawn * (41 + 16 * n_payload)
    return nbytes, ops
