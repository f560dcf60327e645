"""Z-buffer rasterizer of plane records: the CUDA kernels and their twins.

Counterpart of ``synergynet_tpu/render/raster_tiled.py``, whose Pallas TPU
kernels ``_raster_kernel`` (depth + payloads, kernel B2) and
``_raster_kernel_compact`` (depth + winning triangle id, kernel B3) this
replaces with the two entries of ``csrc/raster_tiled.cu``.

1. **Plane records** (:func:`plane_records`, plain torch on the tensor's
   device, shared by the kernel and its twin): every triangle becomes the
   affine planes u(p), v(p), depth(p) and up to 5 payload planes over the
   pixel position p = (x, y), plus its bbox clamped to the canvas, as the
   JAX package's ``_bary_setup`` / ``_plane_setup`` / ``_clamp_and_bins``
   build them (v0 = p2 - p0, v1 = p1 - p0; the relative degeneracy rule
   ``|den| <= 1e-6 * dot00 * dot11`` -> u = v = 0, so a degenerate
   triangle paints its whole bbox with vertex 0's attributes).
2. **Resolve** (:func:`rasterize_records`): a pixel (integer column and
   row as floats, no +0.5) is covered when ``u >= 0, v >= 0, u + v < 1``
   inside the bbox; it draws when its depth is strictly greater than the
   z-buffer's, which starts at ``DEPTH_INIT``; among equal depths the
   lowest triangle index wins. Every covered fragment with depth above
   ``DEPTH_INIT`` offers the int64 key (orderable depth bits << 32 |
   0xFFFFFFFF - triangle), and the pixel keeps the largest: that is the
   JAX merge's contract, whatever order the fragments arrive in.
   Undrawn pixels read ``DEPTH_INIT`` and payload 0.

The TPU kernel's bin sort, replication grid and chunk maps exist to fit
its tile-local gather into VMEM; neither the kernel nor the twin here
needs them.

3. **Deferred payloads** (``rasterize_buffers_tiled(..., deferred=True)``):
   :func:`compact_records` keeps only the u/v/depth planes and the bbox,
   :func:`rasterize_ids` resolves depth and the winning triangle id, and
   :func:`eval_deferred_payloads` evaluates the payload planes once per
   winning pixel, in the same operation order as the payload kernel, so
   both paths give the same buffers bit for bit.
4. **Visibility** (:func:`rasterize_triangles_tiled`): the payload kernel
   with two planes, the triangle id as a constant and w0 = 1 - u - v.

On a CUDA tensor :func:`rasterize_records` and :func:`rasterize_ids`
launch their kernel, or raise; on a CPU tensor they run the plain twins.
The twins (:func:`rasterize_records_reference`,
:func:`rasterize_ids_reference`) enumerate each triangle's bbox pixels,
evaluate the same planes in the same operation order and resolve with
``scatter_reduce_(..., "amax")`` on the same key, so kernels and twins
agree bit for bit. ``rasterize_buffers_tiled.launches`` counts launches of
the payload kernel, ``rasterize_ids.launches`` those of the ids kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from synergynet_tpu_torch.ops.cuda_build import (check_tensor,
                                                 load_kernel_library,
                                                 require_sm90)
from synergynet_tpu_torch.render.raster import DEPTH_INIT

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


def _launch(rec: torch.Tensor, n_payload: int, *, h: int, w: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check what the kernel takes, allocate outputs and the key scratch,
    launch on the current stream. Raises on anything else; never falls
    back."""
    dev = rec.device
    if not 1 <= n_payload <= MAX_PAYLOAD:
        raise ValueError(f"n_payload {n_payload} outside [1, {MAX_PAYLOAD}]")
    check_tensor("records", rec, (torch.float32,),
                 (None, PAYLOAD0 + 3 * n_payload), dev)
    t = rec.shape[0]
    _check_extents(t, h, w, n_payload)
    require_sm90(dev, "raster")
    lib = load_kernel_library("raster_tiled")
    fn = lib.synergy_raster_tiled
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keys = torch.empty((h * w,), dtype=torch.int64, device=dev)
    zbuf = torch.empty((h, w), dtype=torch.float32, device=dev)
    pay = torch.empty((h, w, n_payload), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(rec.data_ptr(), keys.data_ptr(), zbuf.data_ptr(),
                pay.data_ptr(), t, n_payload, h, w, stream)
    if rc != 0:
        raise RuntimeError(f"raster kernel launch failed: CUDA error {rc}")
    rasterize_buffers_tiled.launches += 1
    return zbuf, pay


def rasterize_records(rec: torch.Tensor, n_payload: int, *, h: int, w: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, PAYLOAD0 + 3P) plane records -> (zbuf (h, w) f32 init
    DEPTH_INIT, payloads (h, w, P) f32, 0 where undrawn). On a CUDA tensor
    the kernel ``csrc/raster_tiled.cu`` (or an error); on a CPU tensor the
    plain twin."""
    if rec.device.type == "cuda":
        return _launch(rec, n_payload, h=h, w=w)
    if rec.device.type == "cpu":
        return rasterize_records_reference(rec, n_payload, h=h, w=w)
    raise ValueError(f"no raster kernel for device {rec.device}")


def _check_extents(t: int, h: int, w: int, n_out: int) -> None:
    if not (0 < h and 0 < w and h * w * n_out < 2 ** 31
            and t < 2 ** 31 - 1):
        raise ValueError(f"{t} triangles on a {h}x{w} canvas exceed the "
                         "kernel's 32-bit extents")


def _launch_ids(rec: torch.Tensor, *, h: int, w: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check what the ids kernel takes, allocate outputs and the key
    scratch, launch on the current stream. Raises on anything else; never
    falls back."""
    dev = rec.device
    check_tensor("records", rec, (torch.float32,), (None, PAYLOAD0), dev)
    _check_extents(rec.shape[0], h, w, 1)
    require_sm90(dev, "raster")
    lib = load_kernel_library("raster_tiled")
    fn = lib.synergy_raster_ids
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keys = torch.empty((h * w,), dtype=torch.int64, device=dev)
    zbuf = torch.empty((h, w), dtype=torch.float32, device=dev)
    ids = torch.empty((h, w), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(rec.data_ptr(), keys.data_ptr(), zbuf.data_ptr(),
                ids.data_ptr(), rec.shape[0], PAYLOAD0, h, w, stream)
    if rc != 0:
        raise RuntimeError(f"raster ids kernel launch failed: CUDA error {rc}")
    rasterize_ids.launches += 1
    return zbuf, ids


def rasterize_ids(rec: torch.Tensor, *, h: int, w: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, PAYLOAD0) compact records (:func:`compact_records`) -> (zbuf
    (h, w) f32 init ``DEPTH_INIT``, tri_id (h, w) int32, -1 where
    undrawn): the contract of the JAX package's ``_launch_compact``. On a
    CUDA tensor the ids entry of ``csrc/raster_tiled.cu`` (or an error); on
    a CPU tensor the plain twin :func:`rasterize_ids_reference`."""
    if rec.device.type == "cuda":
        return _launch_ids(rec, h=h, w=w)
    if rec.device.type == "cpu":
        return rasterize_ids_reference(rec, h=h, w=w)
    raise ValueError(f"no raster kernel for device {rec.device}")


rasterize_ids.launches = 0


def compact_records(vertices: torch.Tensor, triangles: torch.Tensor,
                    payloads: torch.Tensor, *, h: int, w: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deferred-payload record build, counterpart of the JAX package's
    ``_plane_setup_compact``: -> ((T, PAYLOAD0) records, which are
    :func:`plane_records` without payloads, and the (T, P, 3) payload
    plane coefficients, computed as :func:`plane_records` computes its
    payload columns). The JAX record's triangle-id field is not needed:
    the kernel's key carries the id."""
    attr_plane, cols, bbox = _bary_setup(vertices, triangles)
    rec = torch.stack(list(cols) + _clamp_bbox(bbox, h=h, w=w), dim=1)
    planes = [torch.stack(attr_plane(*(payloads[:, k][triangles[:, j]]
                                       for j in range(3))), dim=1)
              for k in range(payloads.shape[1])]
    planes = (torch.stack(planes, dim=1) if planes
              else rec.new_zeros((rec.shape[0], 0, 3)))
    return rec, planes


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


def _check_mesh(vertices: torch.Tensor, triangles: torch.Tensor,
                colors=None) -> None:
    dev = vertices.device
    check_tensor("vertices", vertices, (torch.float32,), (None, 3), dev)
    check_tensor("triangles", triangles, (torch.int32, torch.int64),
                 (None, 3), dev)
    if colors is not None:
        check_tensor("colors", colors, (torch.float32,),
                     (vertices.shape[0], 3), dev)


def rasterize_buffers_tiled(vertices: torch.Tensor, triangles: torch.Tensor,
                            colors: torch.Tensor, *, h: int, w: int,
                            deferred: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, 3) f32 image-space vertices, (T, 3) int triangles, (V, 3) f32
    per-vertex colors -> (depth (h, w) f32 init ``DEPTH_INIT``, color
    (h, w, 3) f32, 0 where undrawn): the contract of the JAX package's
    ``rasterize_buffers_tiled``. All three tensors are contiguous and on one
    device; a CUDA device launches the kernels, a CPU device runs the plain
    twins. ``deferred``: resolve depth and winning id only (kernel B3),
    then evaluate the colors per winning pixel; the same buffers."""
    _check_mesh(vertices, triangles, colors)
    if deferred:
        rec, planes = compact_records(vertices, triangles, colors, h=h, w=w)
        zbuf, tri_id = rasterize_ids(rec, h=h, w=w)
        return zbuf, eval_deferred_payloads(tri_id, zbuf > DEPTH_INIT,
                                            planes)
    rec = plane_records(vertices, triangles, colors, h=h, w=w)
    return rasterize_records(rec, 3, h=h, w=w)


rasterize_buffers_tiled.launches = 0


def _visibility_records(vertices: torch.Tensor, triangles: torch.Tensor, *,
                       h: int, w: int) -> torch.Tensor:
    """(T, PAYLOAD0 + 6) records whose two payload planes are the triangle
    id as a constant (exact in f32 below 2^24) and w0 = 1 - u - v, as the
    JAX package's ``_rasterize_visibility`` sets them."""
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
    """Visibility buffers through the payload kernel, the contract of the
    JAX package's ``rasterize_triangles_tiled``: (tri_id (h, w) int32, -1
    where undrawn; depth (h, w) f32 init ``DEPTH_INIT``; barycentric w0
    (h, w) f32, 0 where undrawn)."""
    _check_mesh(vertices, triangles)
    rec = _visibility_records(vertices, triangles, h=h, w=w)
    zbuf, pay = rasterize_records(rec, 2, h=h, w=w)
    drawn = zbuf > DEPTH_INIT
    tri_id = torch.where(drawn, pay[..., 0].to(torch.int32),
                         torch.full_like(zbuf, -1, dtype=torch.int32))
    w0 = torch.where(drawn, pay[..., 1], torch.zeros_like(zbuf))
    return tri_id, zbuf, w0


def rasterize_buffers_reference(vertices: torch.Tensor,
                                triangles: torch.Tensor,
                                colors: torch.Tensor, *, h: int, w: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch twin of :func:`rasterize_buffers_tiled`, on any
    device: the same records, the same plane formula, the same resolve."""
    rec = plane_records(vertices, triangles, colors, h=h, w=w)
    return rasterize_records_reference(rec, 3, h=h, w=w)
