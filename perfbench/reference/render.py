"""The overlay of ``singleImage.py``, plainly: the reference repository's
``Sim3DR`` vertex normals and Phong light (``Sim3DR/lighting.py``, with
its quirks: vertices scaled by the global maximum, the specular power
taken per component before the sum), its z-buffer raster
(``Sim3DR/lib/rasterize_kernel.cpp``: pixels at integer coordinates,
per-pixel barycentric weights from dot products, the larger depth wins
and the earlier triangle on a tie, colours interpolated), the
truncating blend into the frame at alpha 1, then ``cv2.addWeighted``
with the overlay's alpha, rounded half up. Every face is lit on its own.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from perfbench.reference.precision import Precision

LIGHT = dict(ambient=0.75, directional=0.7, specular=0.2, exp=5,
             light_pos=(0.0, 0.0, 5.0), view_pos=(0.0, 0.0, 5.0))
DEPTH_INIT = -1e8
CHUNK = 1 << 22


def _unit(a):
    return a / torch.sqrt((a * a).sum(-1, keepdim=True))


def normals(p: Precision, v: torch.Tensor, tris: torch.Tensor):
    """(V, 3) vertices, (T, 3) triangles -> (V, 3) unit vertex normals:
    each triangle's (p1 - p0) x (p2 - p0) summed into its corners."""
    p0, p1, p2 = (p.q(v[tris[:, k]]) for k in range(3))
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    acc = torch.zeros_like(v).index_add_(0, tris.reshape(-1),
                                         n.repeat_interleave(3, 0))
    return _unit(acc)


def light(p: Precision, v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(V, 3) vertices and normals -> (V, 3) light in [0, 1]."""
    c = LIGHT
    vn = v - v.amin(0)
    vn = vn / vn.amax()
    vn = vn * 2
    vn = vn - vn.amax(0) / 2
    lp = torch.tensor(c["light_pos"], device=v.device)
    vp = torch.tensor(c["view_pos"], device=v.device)
    d = _unit(lp - vn)
    cos = (p.q(n) * p.q(d)).sum(-1, keepdim=True)
    out = c["ambient"] + c["directional"] * cos.clamp(0, 1)
    v2v = _unit(vp - vn)
    refl = 2 * cos * n - d
    spe = (p.q(v2v) * p.q(refl)) ** c["exp"]
    spe = spe.sum(-1, keepdim=True)
    spe = torch.where(cos != 0, spe.clamp(0, 1), torch.zeros_like(spe))
    return (out + c["specular"] * spe.clamp(0, 1)).expand(-1, 3).clamp(0, 1)


def _weights(p, a, b, c, x, y):
    """Barycentric (w0, w1, w2) of pixels (x, y) in triangles (a, b, c),
    the kernel's ``get_point_weight``: u on (c - a), v on (b - a)."""
    v0 = p.q(c[:, :2] - a[:, :2])
    v1 = p.q(b[:, :2] - a[:, :2])
    v2 = p.q(torch.stack([x, y], -1) - a[:, :2])
    d00 = (v0 * v0).sum(-1)
    d01 = (v0 * v1).sum(-1)
    d02 = (v0 * v2).sum(-1)
    d11 = (v1 * v1).sum(-1)
    d12 = (v1 * v2).sum(-1)
    den = d00 * d11 - d01 * d01
    inv = torch.where(den == 0, torch.zeros_like(den),
                      1.0 / torch.where(den == 0, torch.ones_like(den), den))
    u = (d11 * d02 - d01 * d12) * inv
    w = (d00 * d12 - d01 * d02) * inv
    return 1 - u - w, w, u


def rasterize(p: Precision, v: torch.Tensor, tris: torch.Tensor,
              colors: torch.Tensor, h: int, w: int):
    """(V, 3) vertices, (T, 3) triangles, (V, 3) colours -> (drawn (h, w),
    colour (h, w, 3), fragments tested, pixels drawn)."""
    dev = v.device
    a, b, c = (v[tris[:, k]] for k in range(3))
    xs = torch.stack([a[:, 0], b[:, 0], c[:, 0]], 1)
    ys = torch.stack([a[:, 1], b[:, 1], c[:, 1]], 1)
    x0 = torch.floor(xs.amin(1)).clamp(min=0)
    x1 = torch.ceil(xs.amax(1)).clamp(max=w - 1)
    y0 = torch.floor(ys.amin(1)).clamp(min=0)
    y1 = torch.ceil(ys.amax(1)).clamp(max=h - 1)
    nx = (x1 - x0 + 1).clamp(min=0).nan_to_num(0).long()
    ny = (y1 - y0 + 1).clamp(min=0).nan_to_num(0).long()
    count = nx * ny
    frags = int(count.sum())
    best = torch.full((h * w,), DEPTH_INIT, device=dev)
    cand = []
    ends = torch.cumsum(count, 0)
    start = 0
    while start < len(count):
        base = int(ends[start - 1]) if start else 0
        stop = max(int(torch.searchsorted(ends, base + CHUNK, right=True)),
                   start + 1)
        idx = torch.arange(start, stop, device=dev)
        t = torch.repeat_interleave(idx, count[start:stop])
        if len(t):
            n = count[start:stop]
            first = torch.repeat_interleave(ends[start:stop] - n, n) - base
            local = torch.arange(len(t), device=dev) - first
            px = x0[t] + local % nx[t]
            py = y0[t] + local // nx[t]
            w0, w1, w2 = _weights(p, a[t], b[t], c[t], px, py)
            inside = (w2 >= 0) & (w1 >= 0) & (w1 + w2 < 1)
            depth = w0 * a[t, 2] + w1 * b[t, 2] + w2 * c[t, 2]
            ok = inside & (depth > DEPTH_INIT)
            pix = (py * w + px).long()[ok]
            best.scatter_reduce_(0, pix, depth[ok], "amax")
            cand.append((pix, depth[ok], t[ok]))
        start = stop
    first_tri = torch.full((h * w,), len(count), dtype=torch.long, device=dev)
    for pix, depth, t in cand:
        top = depth == best[pix]
        first_tri.scatter_reduce_(0, pix[top], t[top], "amin")
    drawn = first_tri < len(count)
    pix = drawn.nonzero()[:, 0]
    t = first_tri[pix]
    px, py = (pix % w).float(), (pix // w).float()
    w0, w1, w2 = _weights(p, a[t], b[t], c[t], px, py)
    col = torch.zeros((h * w, 3), device=dev)
    ct = [colors[tris[t, k]] for k in range(3)]
    col[pix] = (p.q(w0[:, None]) * p.q(ct[0]) + p.q(w1[:, None]) * p.q(ct[1])
                + p.q(w2[:, None]) * p.q(ct[2]))
    return (drawn.reshape(h, w), col.reshape(h, w, 3), frags,
            int(drawn.sum()))


def overlay(p: Precision, canvas: torch.Tensor, dense: torch.Tensor,
            tris: torch.Tensor, alpha: float) -> Tuple[torch.Tensor, Dict]:
    """(H, W, 3) float canvas and (F, 3, V) canvas-pixel meshes of the
    served faces -> (the (H, W, 3) uint8 overlay, the raster's counts)."""
    frame = canvas.clamp(0, 255).to(torch.uint8)
    h, w = frame.shape[:2]
    if dense.shape[0] == 0:
        return frame, {"frags": 0, "drawn": 0}
    nv = dense.shape[2]
    verts = dense.transpose(1, 2)                          # (F, V, 3)
    lit = torch.cat([light(p, vf, normals(p, vf, tris)) for vf in verts])
    all_tris = torch.cat([tris + i * nv for i in range(verts.shape[0])])
    drawn, col, frags, n = rasterize(p, verts.reshape(-1, 3), all_tris, lit,
                                     h, w)
    solid = torch.where(drawn[..., None],
                        (255.0 * col).nan_to_num(0).clamp(0, 255).floor(),
                        frame.float())
    out = torch.floor((1 - alpha) * frame.float() + alpha * solid + 0.5)
    return out.clamp(0, 255).to(torch.uint8), {"frags": frags, "drawn": n}


def as_served(ov: torch.Tensor, true_hw, size) -> torch.Tensor:
    """An overlay on the canvas -> at the served frame's ``size``: its
    true extent, scaled back by ``cv2.resize`` where the frame was scaled
    onto the canvas."""
    from perfbench.reference.pipeline import resize_linear
    hs, ws = (int(v) for v in true_hw)
    ov = ov[:hs, :ws]
    if tuple(size) != (hs, ws):
        ov = resize_linear(ov, *size).to(torch.uint8)
    return ov
