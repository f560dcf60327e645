"""Z-buffer rasterizer of triangle meshes: the CUDA kernels and their twins.

Counterpart of ``synergynet_tpu/render/raster_tiled.py``, whose Pallas TPU
kernels ``_raster_kernel`` (depth + payloads, kernel B2) and
``_raster_kernel_compact`` (depth + winning triangle id, kernel B3) this
replaces with the two entries of ``csrc/raster_tiled.cu``.

1. **Planes** (the JAX package's ``_bary_setup`` / ``_plane_setup`` /
   ``_clamp_and_bins``): every triangle becomes the affine planes u(p),
   v(p), depth(p) and up to 5 payload planes over the pixel position
   p = (x, y), plus its bbox clamped to the canvas (v0 = p2 - p0,
   v1 = p1 - p0; the relative degeneracy rule
   ``|den| <= 1e-6 * dot00 * dot11`` -> u = v = 0, so a degenerate
   triangle paints its whole bbox with vertex 0's attributes). The kernels
   build them in registers from the mesh; the plain twins stack them into
   plane records (:func:`plane_records`, :func:`compact_records`), rounding
   every operation as the kernels do.
2. **Resolve**: a pixel (integer column and row as floats, no +0.5) is
   covered when ``u >= 0, v >= 0, u + v < 1`` inside the bbox; it draws
   when its depth is strictly greater than the z-buffer's, which starts at
   ``DEPTH_INIT``; among equal depths the lowest triangle index wins.
   Every covered fragment with depth above ``DEPTH_INIT`` offers the int64
   key (orderable depth bits << 32 | 0xFFFFFFFF - triangle), and the pixel
   keeps the largest: that is the JAX merge's contract, whatever order the
   fragments arrive in. Undrawn pixels read ``DEPTH_INIT`` and payload 0.

The TPU kernel's bin sort, replication grid and chunk maps exist to fit
its tile-local gather into VMEM; neither the kernels nor the twins here
need them. So :func:`rasterize_tiled`, the reference-compatible host API
(and ``rasterize``, the same function), takes no ``replication``, and
needs no fallback for a mesh whose replication grid would exceed the JAX
package's budget: any triangle renders whole.

3. **Deferred payloads** (``rasterize_buffers_tiled(..., deferred=True)``):
   :func:`rasterize_mesh_ids` resolves depth and the winning triangle id,
   and :func:`eval_deferred_payloads` evaluates the payload planes of
   :func:`payload_planes` once per winning pixel, in the payload kernel's
   operation order, so both paths give the same buffers bit for bit.
4. **Visibility** (:func:`rasterize_triangles_tiled`): the ids kernel with
   w0 = 1 - u - v of the winner, equal bit for bit to the JAX package's
   route (the payload kernel with the id and w0 as planes,
   :func:`_visibility_records`).

On a CUDA tensor :func:`rasterize_mesh` (B2) and :func:`rasterize_mesh_ids`
(B3) launch their kernel, or raise; no record is built on that path. On a
CPU tensor they run the plain twins (:func:`rasterize_buffers_reference`,
:func:`rasterize_mesh_ids_reference`), which build the records and resolve
them with :func:`rasterize_records_reference` /
:func:`rasterize_ids_reference`: enumerate each triangle's bbox pixels,
evaluate the same planes in the same operation order and keep the key's
max with ``scatter_reduce_(..., "amax")``, so kernels and twins agree bit
for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.ops.cuda_build import (check_tensor, launch,
                                                 require_sm90)
from synergynet_tpu_torch.render.raster import (DEPTH_INIT, as_tensor,
                                                blend_uint8, no_window)

# Record row layout (f32), width PAYLOAD0 + 3 * n_payload:
#   0-2    Au Bu Cu        u(p) = (Au*x + Bu*y) + Cu
#   3-5    Av Bv Cv        v(p)
#   6-8    Ad Bd Cd        depth(p)
#   9-12   x_min x_max y_min y_max   (clamped inclusive bbox, integers)
#   13-    payload planes, 3 coefficients each
BBOX0 = 9
PAYLOAD0 = 13
MAX_PAYLOAD = 5
# Bbox limits beyond the canvas: integers exact in f32 and in int32, so
# far-off (parked, +1e7) or non-finite triangles clamp to an empty bbox
# without overflow; below 2^24 the clamp is the JAX package's.
_FAR = float(2 ** 24)
_EMPTY_KEY = -(2 ** 63)
_LOW = 0xFFFFFFFF
# Fragments per chunk of the plain twin: bounds its memory at ~1 GB.
_CHUNK_FRAGMENTS = 1 << 22


def _bary_setup(vertices: torch.Tensor, triangles: torch.Tensor):
    """(V, 3) verts + (T, 3) tris -> (attr_plane, base_cols, bbox_cols):
    ``attr_plane(a0, a1, a2)`` compiles a per-vertex attribute into its 3
    affine coefficients, ``base_cols`` are the 9 u/v/depth coefficients and
    ``bbox_cols`` the 4 unclamped bbox bounds."""
    p0 = vertices[triangles[:, 0]]
    p1 = vertices[triangles[:, 1]]
    p2 = vertices[triangles[:, 2]]

    v0 = p2[:, :2] - p0[:, :2]
    v1 = p1[:, :2] - p0[:, :2]
    dot00 = (v0 * v0).sum(1)
    dot01 = (v0 * v1).sum(1)
    dot11 = (v1 * v1).sum(1)
    den = dot00 * dot11 - dot01 * dot01
    degenerate = den.abs() <= 1e-6 * dot00 * dot11
    inv = torch.where(degenerate, torch.zeros_like(den),
                      1.0 / torch.where(degenerate, torch.ones_like(den),
                                        den))

    au = (dot11 * v0[:, 0] - dot01 * v1[:, 0]) * inv
    bu = (dot11 * v0[:, 1] - dot01 * v1[:, 1]) * inv
    cu = -(au * p0[:, 0] + bu * p0[:, 1])
    av = (dot00 * v1[:, 0] - dot01 * v0[:, 0]) * inv
    bv = (dot00 * v1[:, 1] - dot01 * v0[:, 1]) * inv
    cv = -(av * p0[:, 0] + bv * p0[:, 1])

    def attr_plane(a0, a1, a2):
        # value(p) = a0 + (a2 - a0) * u + (a1 - a0) * v   (w1 = v, w2 = u)
        du, dv = a2 - a0, a1 - a0
        return (du * au + dv * av, du * bu + dv * bv,
                a0 + du * cu + dv * cv)

    base = [au, bu, cu, av, bv, cv, *attr_plane(p0[:, 2], p1[:, 2], p2[:, 2])]
    xs = torch.stack([p0[:, 0], p1[:, 0], p2[:, 0]], 1)
    ys = torch.stack([p0[:, 1], p1[:, 1], p2[:, 1]], 1)
    bbox = [torch.floor(xs.amin(1)), torch.ceil(xs.amax(1)),
            torch.floor(ys.amin(1)), torch.ceil(ys.amax(1))]
    return attr_plane, base, bbox


def _clamp_bbox(bbox, *, h: int, w: int):
    """Clamp the bbox to the canvas (reference rasterize_kernel.cpp:
    244-252) in float; an empty bbox has max < min. NaN bounds become
    empty."""
    x0, x1, y0, y1 = bbox
    return [torch.nan_to_num(x0.clamp(0.0, _FAR), nan=_FAR),
            torch.nan_to_num(x1.clamp(-_FAR, w - 1.0), nan=-_FAR),
            torch.nan_to_num(y0.clamp(0.0, _FAR), nan=_FAR),
            torch.nan_to_num(y1.clamp(-_FAR, h - 1.0), nan=-_FAR)]


def plane_records(vertices: torch.Tensor, triangles: torch.Tensor,
                  payloads: torch.Tensor, *, h: int, w: int) -> torch.Tensor:
    """(V, 3) f32 verts + (T, 3) int tris + (V, P) f32 per-vertex payloads
    -> (T, PAYLOAD0 + 3P) f32 contiguous plane records for an (h, w)
    canvas."""
    attr_plane, cols, bbox = _bary_setup(vertices, triangles)
    cols = list(cols) + _clamp_bbox(bbox, h=h, w=w)
    for k in range(payloads.shape[1]):
        col = payloads[:, k]
        cols.extend(attr_plane(*(col[triangles[:, j]] for j in range(3))))
    return torch.stack(cols, dim=1)


def _plane(a, b, c, x, y):
    """(a*x + b*y) + c, every operation rounded on its own: the kernel's
    __fmul_rn/__fadd_rn order and the JAX kernel's ``plane``."""
    return a * x + b * y + c


def _reference_keys(rec: torch.Tensor, *, h: int, w: int) -> torch.Tensor:
    """The twins' resolve: enumerate every bbox pixel, build the keys, keep
    the per-pixel max. -> (h * w) int64 keys, ``_EMPTY_KEY`` where
    undrawn."""
    dev = rec.device
    t = rec.shape[0]
    keys = torch.full((h * w,), _EMPTY_KEY, dtype=torch.int64, device=dev)
    bb = rec[:, BBOX0:BBOX0 + 4].long()
    nx = (bb[:, 1] - bb[:, 0] + 1).clamp(min=0)
    ny = (bb[:, 3] - bb[:, 2] + 1).clamp(min=0)
    n = nx * ny
    cum = torch.cumsum(n, 0)
    cum_host = cum.cpu()
    start = 0
    while start < t:
        base = int(cum_host[start - 1]) if start else 0
        end = int(torch.searchsorted(cum_host, base + _CHUNK_FRAGMENTS,
                                     right=True))
        end = max(end, start + 1)
        total = int(cum_host[end - 1]) - base
        if total:
            tri = torch.repeat_interleave(
                torch.arange(start, end, device=dev), n[start:end],
                output_size=total)
            first = torch.repeat_interleave(cum[start:end] - n[start:end]
                                            - base, n[start:end],
                                            output_size=total)
            local = torch.arange(total, device=dev) - first
            px = bb[tri, 0] + local % nx[tri]
            py = bb[tri, 2] + local // nx[tri]
            r = rec[tri, :9]
            x, y = px.float(), py.float()
            u = _plane(r[:, 0], r[:, 1], r[:, 2], x, y)
            v = _plane(r[:, 3], r[:, 4], r[:, 5], x, y)
            d = _plane(r[:, 6], r[:, 7], r[:, 8], x, y)
            ok = (u >= 0) & (v >= 0) & (u + v < 1) & (d > DEPTH_INIT)
            d = torch.where(d == 0, torch.zeros_like(d), d)[ok]
            s = d.view(torch.int32)
            s = torch.where(s < 0, s ^ 0x7FFFFFFF, s).long()
            key = (s << 32) | (_LOW - tri[ok])
            keys.scatter_reduce_(0, py[ok] * w + px[ok], key, "amax")
        start = end
    return keys


def _decode_keys(keys: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N,) keys -> (drawn, depth (``DEPTH_INIT`` where undrawn), winning
    triangle (int64, 0 where undrawn))."""
    drawn = keys > _EMPTY_KEY
    s = (keys >> 32).to(torch.int32)
    depth = torch.where(s < 0, s ^ 0x7FFFFFFF, s).view(torch.float32)
    zbuf = torch.where(drawn, depth, torch.full_like(depth, DEPTH_INIT))
    tri = torch.where(drawn, _LOW - (keys & _LOW), torch.zeros_like(keys))
    return drawn, zbuf, tri


def rasterize_records_reference(rec: torch.Tensor, n_payload: int, *,
                                h: int, w: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch twin of the payload kernel, on any device:
    enumerate every bbox pixel, build the keys, keep the per-pixel max,
    decode."""
    t = rec.shape[0]
    drawn, zbuf, tri = _decode_keys(_reference_keys(rec, h=h, w=w))
    pix = torch.arange(h * w, device=rec.device)
    x, y = (pix % w).float(), (pix // w).float()
    pay = []
    for k in range(n_payload):
        o = PAYLOAD0 + 3 * k
        c = rec[tri, o:o + 3] if t else rec.new_zeros((h * w, 3))
        val = _plane(c[:, 0], c[:, 1], c[:, 2], x, y)
        pay.append(torch.where(drawn, val, torch.zeros_like(val)))
    color = (torch.stack(pay, dim=1) if pay
             else rec.new_zeros((h * w, 0)))
    return zbuf.reshape(h, w), color.reshape(h, w, n_payload)


def rasterize_ids_reference(rec: torch.Tensor, *, h: int, w: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch twin of the ids kernel, on any device: the key
    build and ``scatter_reduce_(amax)`` of :func:`rasterize_records_reference`,
    decoded to (zbuf (h, w) f32, ``DEPTH_INIT`` where undrawn; tri_id (h, w)
    int32, -1 where undrawn). Payload planes in ``rec``, if any, are not
    read."""
    drawn, zbuf, tri = _decode_keys(_reference_keys(rec, h=h, w=w))
    tri_id = torch.where(drawn, tri, torch.full_like(tri, -1))
    return zbuf.reshape(h, w), tri_id.to(torch.int32).reshape(h, w)


def _attr_planes(attr_plane, triangles: torch.Tensor,
                 payloads: torch.Tensor) -> torch.Tensor:
    """(T, P, 3) payload plane coefficients, as :func:`plane_records`
    computes its payload columns."""
    planes = [torch.stack(attr_plane(*(payloads[:, k][triangles[:, j]]
                                       for j in range(3))), dim=1)
              for k in range(payloads.shape[1])]
    return (torch.stack(planes, dim=1) if planes
            else payloads.new_zeros((triangles.shape[0], 0, 3)))


def payload_planes(vertices: torch.Tensor, triangles: torch.Tensor,
                   payloads: torch.Tensor) -> torch.Tensor:
    """(V, 3) verts + (T, 3) tris + (V, P) payloads -> the (T, P, 3) payload
    plane coefficients that :func:`eval_deferred_payloads` evaluates: the
    second output of :func:`compact_records`, built without its
    records."""
    attr_plane, _, _ = _bary_setup(vertices, triangles)
    return _attr_planes(attr_plane, triangles, payloads)


def compact_records(vertices: torch.Tensor, triangles: torch.Tensor,
                    payloads: torch.Tensor, *, h: int, w: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deferred-payload record build, counterpart of the JAX package's
    ``_plane_setup_compact``: -> ((T, PAYLOAD0) records, which are
    :func:`plane_records` without payloads, and the (T, P, 3) payload
    plane coefficients of :func:`payload_planes`). The JAX record's
    triangle-id field is not needed: the key carries the id."""
    attr_plane, cols, bbox = _bary_setup(vertices, triangles)
    rec = torch.stack(list(cols) + _clamp_bbox(bbox, h=h, w=w), dim=1)
    return rec, _attr_planes(attr_plane, triangles, payloads)


def eval_deferred_payloads(tri_id: torch.Tensor, drawn: torch.Tensor,
                           planes: torch.Tensor) -> torch.Tensor:
    """(h, w) winning ids + (h, w) drawn mask + (T, P, 3) payload planes ->
    (h, w, P) payloads, 0 where undrawn: one plane evaluation per winning
    pixel, counterpart of the JAX package's ``_eval_deferred_payloads``
    (which returns (P, h, w)). Plain torch, as JAX runs it outside its
    kernel: (a*x + b*y) + c with every operation rounded on its own, the
    payload kernel's order, so the deferred payloads equal the in-kernel
    ones bit for bit."""
    h, w = tri_id.shape
    p = planes.shape[1]
    if planes.shape[0] == 0:
        return planes.new_zeros((h, w, p))
    c = planes[tri_id.clamp(0, planes.shape[0] - 1).long()]   # (h, w, P, 3)
    dev = planes.device
    x = torch.arange(w, device=dev, dtype=torch.float32)[None, :, None]
    y = torch.arange(h, device=dev, dtype=torch.float32)[:, None, None]
    val = _plane(c[..., 0], c[..., 1], c[..., 2], x, y)
    return torch.where(drawn[..., None], val, torch.zeros_like(val))


# The C entries of csrc/raster_tiled.cu: pointers, then ints (the stream
# follows).
_MESH_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
_MESH_IDS_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5


def _check_mesh(vertices: torch.Tensor, triangles: torch.Tensor,
                payloads=None, *, h: int, w: int) -> None:
    """Raise unless the mesh is what the kernels take: contiguous (V, 3)
    f32 vertices, (T, 3) int32 or int64 triangles and (V, P) f32 payloads
    with 1 <= P <= MAX_PAYLOAD, all on one device, within 32-bit
    extents."""
    dev = vertices.device
    check_tensor("vertices", vertices, (torch.float32,), (None, 3), dev)
    check_tensor("triangles", triangles, (torch.int32, torch.int64),
                 (None, 3), dev)
    n_out = 1
    if payloads is not None:
        check_tensor("payloads", payloads, (torch.float32,),
                     (vertices.shape[0], None), dev)
        n_out = payloads.shape[1]
        if not 1 <= n_out <= MAX_PAYLOAD:
            raise ValueError(f"{n_out} payloads outside [1, {MAX_PAYLOAD}]")
    t, v = triangles.shape[0], vertices.shape[0]
    if not (0 < h and 0 < w and h * w * n_out < 2 ** 31
            and t < 2 ** 31 - 1 and v < 2 ** 31):
        raise ValueError(f"{t} triangles of {v} vertices on a {h}x{w} "
                         "canvas exceed the kernels' 32-bit extents")


def rasterize_mesh(vertices: torch.Tensor, triangles: torch.Tensor,
                   payloads: torch.Tensor, *, h: int, w: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, 3) f32 image-space vertices, (T, 3) int32 or int64 triangles,
    (V, P) f32 per-vertex payloads (1 <= P <= 5) -> (zbuf (h, w) f32 init
    ``DEPTH_INIT``, payloads (h, w, P) f32, 0 where undrawn). On a CUDA
    tensor the payload entry of ``csrc/raster_tiled.cu`` (kernel B2), which
    builds each triangle's planes in registers, or an error; on a CPU
    tensor the plain twin :func:`rasterize_buffers_reference`."""
    _check_mesh(vertices, triangles, payloads, h=h, w=w)
    dev = vertices.device
    if dev.type == "cpu":
        return rasterize_buffers_reference(vertices, triangles, payloads,
                                           h=h, w=w)
    if dev.type != "cuda":
        raise ValueError(f"no raster kernel for device {dev}")
    require_sm90(dev, "raster")
    n_payload = payloads.shape[1]
    keys = torch.empty((h * w,), dtype=torch.int64, device=dev)
    zbuf = torch.empty((h, w), dtype=torch.float32, device=dev)
    out = torch.empty((h, w, n_payload), dtype=torch.float32, device=dev)
    launch("raster_tiled", "synergy_raster_mesh", _MESH_ARGS, dev,
           vertices, triangles, payloads, keys, zbuf, out,
           int(triangles.dtype == torch.int64), vertices.shape[0],
           triangles.shape[0], n_payload, h, w)
    return zbuf, out


def rasterize_mesh_ids(vertices: torch.Tensor, triangles: torch.Tensor, *,
                       h: int, w: int, w0: bool = False):
    """(V, 3) f32 image-space vertices, (T, 3) int32 or int64 triangles ->
    (zbuf (h, w) f32 init ``DEPTH_INIT``, tri_id (h, w) int32, -1 where
    undrawn) and, with ``w0``, the winner's barycentric w0 = 1 - u - v
    (h, w) f32, 0 where undrawn. On a CUDA tensor the ids entry of
    ``csrc/raster_tiled.cu`` (kernel B3), or an error; on a CPU tensor the
    plain twin :func:`rasterize_mesh_ids_reference`."""
    _check_mesh(vertices, triangles, h=h, w=w)
    dev = vertices.device
    if dev.type == "cpu":
        return rasterize_mesh_ids_reference(vertices, triangles, h=h, w=w,
                                            w0=w0)
    if dev.type != "cuda":
        raise ValueError(f"no raster kernel for device {dev}")
    require_sm90(dev, "raster")
    keys = torch.empty((h * w,), dtype=torch.int64, device=dev)
    zbuf = torch.empty((h, w), dtype=torch.float32, device=dev)
    ids = torch.empty((h, w), dtype=torch.int32, device=dev)
    bary = torch.empty((h, w), dtype=torch.float32, device=dev) if w0 else None
    launch("raster_tiled", "synergy_raster_mesh_ids", _MESH_IDS_ARGS, dev,
           vertices, triangles, keys, zbuf, ids, bary,
           int(triangles.dtype == torch.int64), vertices.shape[0],
           triangles.shape[0], h, w)
    return (zbuf, ids, bary) if w0 else (zbuf, ids)


def rasterize_mesh_ids_reference(vertices: torch.Tensor,
                                 triangles: torch.Tensor, *, h: int, w: int,
                                 w0: bool = False):
    """The plain PyTorch twin of :func:`rasterize_mesh_ids`, on any device:
    :func:`compact_records` without payloads, :func:`rasterize_ids_reference`
    and, with ``w0``, the winner's plane (-(Au + Av), -(Bu + Bv),
    1 - (Cu + Cv)) at the pixel, the order of the JAX package's
    ``_rasterize_visibility``."""
    rec, _ = compact_records(vertices, triangles,
                             vertices.new_zeros((vertices.shape[0], 0)),
                             h=h, w=w)
    zbuf, tri_id = rasterize_ids_reference(rec, h=h, w=w)
    if not w0:
        return zbuf, tri_id
    drawn = tri_id >= 0
    r = rec[tri_id.clamp(min=0).long()] if rec.shape[0] else rec.new_zeros(
        (h, w, PAYLOAD0))
    x = torch.arange(w, device=rec.device, dtype=torch.float32)[None, :]
    y = torch.arange(h, device=rec.device, dtype=torch.float32)[:, None]
    val = _plane(-(r[..., 0] + r[..., 3]), -(r[..., 1] + r[..., 4]),
                 1.0 - (r[..., 2] + r[..., 5]), x, y)
    return zbuf, tri_id, torch.where(drawn, val, torch.zeros_like(val))


def rasterize_buffers_tiled(vertices: torch.Tensor, triangles: torch.Tensor,
                            colors: torch.Tensor, *, h: int, w: int,
                            deferred: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, 3) f32 image-space vertices, (T, 3) int32 or int64 triangles,
    (V, 3) f32 per-vertex colors -> (depth (h, w) f32 init ``DEPTH_INIT``,
    color (h, w, 3) f32, 0 where undrawn): the contract of the JAX
    package's ``rasterize_buffers_tiled`` (any 1-5 payload columns in place
    of the colors). All three tensors are contiguous and on one device; a
    CUDA device launches the kernels, a CPU device runs the plain twins.
    ``deferred``: resolve depth and winning id only (kernel B3), then
    evaluate the colors per winning pixel from :func:`payload_planes`; the
    same buffers."""
    _check_mesh(vertices, triangles, colors, h=h, w=w)
    if not deferred:
        return rasterize_mesh(vertices, triangles, colors, h=h, w=w)
    zbuf, tri_id = rasterize_mesh_ids(vertices, triangles, h=h, w=w)
    return zbuf, eval_deferred_payloads(
        tri_id, zbuf > DEPTH_INIT, payload_planes(vertices, triangles, colors))


def _visibility_records(vertices: torch.Tensor, triangles: torch.Tensor, *,
                       h: int, w: int) -> torch.Tensor:
    """(T, PAYLOAD0 + 6) records whose two payload planes are the triangle
    id as a constant (exact in f32 below 2^24) and w0 = 1 - u - v, as the
    JAX package's ``_rasterize_visibility`` sets them: the record route of
    the visibility path, which :func:`rasterize_mesh_ids` with ``w0``
    equals bit for bit."""
    _, cols, bbox = _bary_setup(vertices, triangles)
    au, bu, cu, av, bv, cv = cols[:6]
    t = triangles.shape[0]
    zero = torch.zeros_like(au)
    ids = torch.arange(t, device=vertices.device, dtype=torch.float32)
    return torch.stack(list(cols) + _clamp_bbox(bbox, h=h, w=w)
                       + [zero, zero, ids, -(au + av), -(bu + bv),
                          1.0 - (cu + cv)], dim=1)


def rasterize_triangles_tiled(vertices: torch.Tensor,
                              triangles: torch.Tensor, *, h: int, w: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Visibility buffers, the contract of the JAX package's
    ``rasterize_triangles_tiled``: (tri_id (h, w) int32, -1 where undrawn;
    depth (h, w) f32 init ``DEPTH_INIT``; barycentric w0 (h, w) f32, 0
    where undrawn). The JAX package runs its payload kernel with the id
    and w0 as planes; here the ids kernel (B3) resolves the id and
    evaluates w0 for the winner, with the same result."""
    zbuf, tri_id, w0 = rasterize_mesh_ids(vertices, triangles, h=h, w=w,
                                          w0=True)
    return tri_id, zbuf, w0


def rasterize_buffers_reference(vertices: torch.Tensor,
                                triangles: torch.Tensor,
                                payloads: torch.Tensor, *, h: int, w: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch twin of :func:`rasterize_mesh` and of
    :func:`rasterize_buffers_tiled`, on any device: :func:`plane_records`,
    then :func:`rasterize_records_reference`."""
    rec = plane_records(vertices, triangles, payloads, h=h, w=w)
    return rasterize_records_reference(rec, payloads.shape[1], h=h, w=w)


# -- the reference-compatible host APIs ---------------------------------------
#
# The JAX versions render every triangle through a fragment window anchored
# at its bbox, which ``window_for`` caps at 32 px: a larger triangle is
# cropped to the window. Here every triangle renders whole, through B2 (the
# colors) or B3 (the visibility), so the results equal the JAX package's
# only where its window covers every triangle; where a triangle spans more
# than 32 px the port draws what JAX crops. A ``window`` (or ``win_h`` /
# ``win_w``) other than ``None`` raises: there is no window to set. The
# coverage and depth come from the kernels' affine planes, which round
# differently from the window path's per-fragment dot products, so a pixel
# on a triangle's edge, or on a depth tie between two triangles, can fall
# the other way.


def rasterize_buffers(vertices, triangles, colors, *, h: int, w: int,
                      win_h: Optional[int] = None,
                      win_w: Optional[int] = None, device="cuda"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve the z-buffer of vertices (V, 3) f32 image-space, triangles
    (T, 3) int and colors (V, 1-5) on ``device`` (the card unless the
    caller asks for the CPU) -> (depth (h, w) f32 init ``DEPTH_INIT``,
    colors (h, w, P), 0 where undrawn), tensors on ``device``:
    :func:`rasterize_mesh` on arrays or tensors of any device. Equals the
    JAX package's result where its window covers every triangle."""
    no_window((win_h, win_w))
    dev = resolve_device(device)
    return rasterize_mesh(as_tensor(vertices, torch.float32, dev),
                          as_tensor(triangles, torch.int32, dev),
                          as_tensor(colors, torch.float32, dev), h=h, w=w)


def rasterize_triangles(vertices, triangles, *, h: int, w: int,
                        win_h: Optional[int] = None,
                        win_w: Optional[int] = None, device="cuda"
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Visibility buffers on ``device`` (the card unless the caller asks
    for the CPU), the reference's ``_rasterize_triangles``
    (rasterize_kernel.cpp:290-348): :func:`rasterize_triangles_tiled` on
    arrays or tensors of any device -> (tri_id, depth, bary_w0). Equals the
    JAX package's result where its window covers every triangle."""
    no_window((win_h, win_w))
    dev = resolve_device(device)
    return rasterize_triangles_tiled(as_tensor(vertices, torch.float32, dev),
                                     as_tensor(triangles, torch.int32, dev),
                                     h=h, w=w)


def rasterize_tiled(vertices, triangles, colors, bg=None, height=None,
                    width=None, channel=None, reverse: bool = False,
                    alpha: float = 1.0,
                    window: Optional[Tuple[int, int]] = None, device="cuda"
                    ) -> np.ndarray:
    """Reference-compatible host API (Sim3DR/Sim3DR.py:15-29), the JAX
    package's ``rasterize_tiled`` and ``rasterize``: vertices (V, 3) f32
    image-space, triangles (T, 3) int, colors (V, 3) in [0, 1] (1-5
    columns), an optional uint8 background (else zeros of ``height`` x
    ``width`` x ``channel``) -> uint8 image (numpy), rendered on ``device``
    (the card unless the caller asks for the CPU):
    :func:`rasterize_buffers`, then
    :func:`~synergynet_tpu_torch.render.raster.blend_uint8` at ``alpha``,
    rows flipped with ``reverse``. ``window`` must be ``None``."""
    no_window(window)
    dev = resolve_device(device)
    if bg is not None:
        height, width, channel = bg.shape
        bg = np.asarray(bg, np.uint8)
    elif height is None or width is None:
        raise ValueError("pass a background or its height and width")
    else:
        bg = np.zeros((height, width, channel or 3), np.uint8)
    zbuf, color = rasterize_buffers(vertices, triangles, colors, h=height,
                                    w=width, device=dev)
    out = blend_uint8(torch.from_numpy(bg).to(dev), zbuf, color,
                      float(alpha), reverse=reverse)
    return out.cpu().numpy()


rasterize = rasterize_tiled
