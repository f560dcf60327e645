"""Mesh file outputs and UV texture utilities (host numpy).

Counterpart of ``synergynet_tpu/pipeline/outputs.py``, writing the same
files byte for byte. Equivalents of the reference's obj writers (utils/inference.py:8-23,
artistic.py:19-31) and the BFM-UV color lookup used by the artistic /
real-face texture apps (artistic.py:45-49,112-117,
uv_texture_realFaces.py:46-51,105-112). Writers are vectorized string
formatting rather than per-vertex Python loops.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from synergynet_tpu_torch.mm3d.assets import NVER, load_param_pack


def _ensure_obj(path: str) -> str:
    return path if path.endswith(".obj") else path + ".obj"


def write_obj(path: str, vertices: np.ndarray, triangles: np.ndarray) -> str:
    """Plain mesh: vertices (3, V); triangles (3, T) 1-based; faces written
    reversed (f t2 t1 t0) like the reference (utils/inference.py:20-23)."""
    path = _ensure_obj(path)
    v = np.asarray(vertices)
    t = np.asarray(triangles)
    with open(path, "w") as f:
        f.writelines(f"v {v[0, i]:.4f} {v[1, i]:.4f} {v[2, i]:.4f}\n"
                     for i in range(v.shape[1]))
        f.writelines(f"f {t[2, i]} {t[1, i]} {t[0, i]}\n"
                     for i in range(t.shape[1]))
    return path


def write_obj_with_colors(path: str, vertices: np.ndarray,
                          triangles: np.ndarray, colors: np.ndarray) -> str:
    """Per-vertex colored mesh (artistic.py:19-31): colors (V, 3) BGR —
    written as RGB by swapping channels, faces in direct order 1-based."""
    path = _ensure_obj(path)
    v = np.asarray(vertices)
    t = np.asarray(triangles)
    c = np.asarray(colors)
    with open(path, "w") as f:
        f.writelines(
            f"v {v[0, i]:.4f} {v[1, i]:.4f} {v[2, i]:.4f} "
            f"{c[i, 2]} {c[i, 1]} {c[i, 0]}\n"
            for i in range(v.shape[1]))
        f.writelines(f"f {t[0, i]} {t[1, i]} {t[2, i]}\n"
                     for i in range(t.shape[1]))
    return path


def write_obj_with_colors_texture(path: str, vertices: np.ndarray,
                                  triangles: np.ndarray,
                                  colors: np.ndarray,
                                  uv_coords: np.ndarray,
                                  mtl_name: Optional[str] = None,
                                  texture_name: str = "texture.png") -> str:
    """mtl-referencing textured obj (reference ``_write_obj_with_colors_
    texture``, Sim3DR/lib/rasterize_kernel.cpp:464-512 — dead code there:
    never exposed through rasterize.pyx; implemented here for capability
    completeness).

    Layout follows the reference: ``mtllib`` header; ``v x y z r g b``
    per-vertex lines (colors (V, 3), written as-is); ``vt u v`` lines for
    ``uv_coords`` (V, 2); ``usemtl FaceTexture``; faces reversed with
    vertex/uv indices ``f t2/t2 t1/t1 t0/t0`` (1-based ``triangles``
    (3, T)). One deliberate divergence: the reference's v-line glues z and
    r together with no separator (``<< vertices[3i+2] << colors[3i]``, an
    obvious stream bug in dead code) — a space is emitted instead so the
    file parses. A minimal companion ``.mtl`` is also written (the
    reference names one but never creates it).
    """
    path = _ensure_obj(path)
    if mtl_name is None:
        mtl_name = os.path.splitext(os.path.basename(path))[0] + ".mtl"
    v = np.asarray(vertices)
    t = np.asarray(triangles)
    c = np.asarray(colors)
    uv = np.asarray(uv_coords)
    with open(path, "w") as f:
        f.write(f"mtllib {mtl_name}\n")
        f.writelines(
            f"v {v[0, i]:.4f} {v[1, i]:.4f} {v[2, i]:.4f} "
            f"{c[i, 0]} {c[i, 1]} {c[i, 2]}\n"
            for i in range(v.shape[1]))
        f.writelines(f"vt {uv[i, 0]:.6f} {uv[i, 1]:.6f}\n"
                     for i in range(uv.shape[0]))
        f.write("usemtl FaceTexture\n")
        f.writelines(
            f"f {t[2, i]}/{t[2, i]} {t[1, i]}/{t[1, i]} {t[0, i]}/{t[0, i]}\n"
            for i in range(t.shape[1]))
    mtl_path = os.path.join(os.path.dirname(path) or ".", mtl_name)
    with open(mtl_path, "w") as f:
        f.write("newmtl FaceTexture\n"
                f"map_Kd {texture_name}\n")
    return path


class UVTextureMapper:
    """BFM UV-space color lookup (artistic.py:45-49).

    ``uv_vert`` is the (V, 2) BFM_UV table in [0, 1]; a 256x256 texture image
    is sampled at integer (u*255, v*255). ``keep_ind`` / ``tri_deletion``
    optionally trim the mesh to the face region with its matching 1-based
    triangle list.
    """

    def __init__(self, uv_vert: np.ndarray,
                 keep_ind: Optional[np.ndarray] = None,
                 tri_deletion: Optional[np.ndarray] = None):
        uv = np.asarray(uv_vert, np.float64)
        self.coord_u = (uv[:, 1] * 255.0).astype(np.int32)
        self.coord_v = (uv[:, 0] * 255.0).astype(np.int32)
        self.keep_ind = None if keep_ind is None else np.asarray(keep_ind)
        self.tri_deletion = (None if tri_deletion is None
                             else np.asarray(tri_deletion))

    @classmethod
    def synthetic(cls, nver: int, seed: int = 0) -> "UVTextureMapper":
        """Deterministic stand-in when the BFM_UV asset is unavailable:
        a smooth cylindrical-ish unwrap over vertex index."""
        rng = np.random.default_rng(seed)
        g = np.linspace(0, 1, nver)
        uv = np.stack([g, (np.sin(g * 37.0) * 0.5 + 0.5)], 1)
        uv += rng.uniform(-1e-3, 1e-3, uv.shape)
        keep = np.arange(nver // 8, nver - nver // 8, dtype=np.int64)
        return cls(np.clip(uv, 0, 1), keep_ind=keep)

    def colors_from_texture(self, texture_bgr: np.ndarray,
                            flip_vertical: bool = True) -> np.ndarray:
        """(256, 256, 3) uint8 UV texture -> (V, 3) per-vertex colors.
        The reference flips the texture vertically before lookup
        (artistic.py:111-113)."""
        tex = np.flip(texture_bgr, axis=0) if flip_vertical else texture_bgr
        return tex[self.coord_u, self.coord_v, :]

    def trim(self, vertices: np.ndarray, colors: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """Apply keep_ind/tri_deletion -> (vertices', colors', tri 1-based)."""
        if self.keep_ind is None:
            raise ValueError("no keep_ind available")
        v = np.asarray(vertices)[:, self.keep_ind]
        c = None if colors is None else np.asarray(colors)[self.keep_ind]
        tri = self.tri_deletion
        if tri is None:
            # Rebuild a valid 1-based triangle list over kept vertices.
            tri = _reindex_triangles(self.keep_ind, len(self.coord_u))
        return v, c, tri


def _reindex_triangles(keep_ind: np.ndarray, nver: int) -> np.ndarray:
    """Fallback (3, T') 1-based triangles over the kept subset, derived from
    the active ParamPack topology."""
    tri = load_param_pack().tri.numpy()              # (3, T) 0-based
    mask = np.zeros(nver, bool)
    mask[keep_ind] = True
    kept = mask[tri].all(0)
    remap = np.full(nver, -1, np.int64)
    remap[keep_ind] = np.arange(len(keep_ind))
    return (remap[tri[:, kept]] + 1).astype(np.int32)


def load_uv_assets(d: Optional[str] = None) -> UVTextureMapper:
    """Load BFM_UV.npy (+ keptInd.npy / deletedTri.npy) from a 3dmm_data
    directory, or fall back to the synthetic unwrap."""
    d = d or os.environ.get("SYNERGY_3DMM_DATA")
    if d and os.path.exists(os.path.join(d, "BFM_UV.npy")):
        uv = np.load(os.path.join(d, "BFM_UV.npy"))
        ki = tp = None
        if os.path.exists(os.path.join(d, "keptInd.npy")):
            ki = np.load(os.path.join(d, "keptInd.npy"))
        if os.path.exists(os.path.join(d, "deletedTri.npy")):
            tp = np.load(os.path.join(d, "deletedTri.npy"))
        return UVTextureMapper(uv, keep_ind=ki, tri_deletion=tp)
    return UVTextureMapper.synthetic(NVER)
