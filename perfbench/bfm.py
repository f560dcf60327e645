"""The synthetic 3DMM pack both sides are given, made and cached by the
benchmark.

A frozen copy of the generator that the program's repository uses for its
default pack (the seed-0 synthetic Basel-Face-Model-shaped arrays: 53,215
vertices, 105,840 triangles, 40 shape and 10 expression bases, 68
keypoints), so that no later change to the program moves the pack the
benchmark measures with. :func:`load` writes it once to
``build/perfbench/bfm_synth_seed<seed>.npz`` in the checkout and reads it
from there after.
"""

from __future__ import annotations

import os

import numpy as np

NVER = 53_215
NTRI = 105_840
N_SHP = 40
N_EXP = 10
N_PARAM = 62
N_LMK = 68
STD_SIZE = 120
GRID_H = 205
GRID_W = 259
KEYS = ("u_shp", "u_exp", "w_shp", "w_exp", "keypoints", "param_mean",
        "param_std", "tri")


def _smooth_field(rng: np.random.Generator, h: int, w: int, n: int,
                  cutoff: int = 6) -> np.ndarray:
    """n smooth random scalar fields on an h x w grid via low-freq Fourier."""
    yy = np.linspace(0.0, 1.0, h)[:, None]
    xx = np.linspace(0.0, 1.0, w)[None, :]
    out = np.zeros((n, h, w), np.float64)
    for k in range(n):
        for fy in range(cutoff):
            for fx in range(cutoff):
                if fx == 0 and fy == 0:
                    continue
                amp = rng.standard_normal(2) / (1.0 + fy * fy + fx * fx)
                phase = 2 * np.pi * (fy * yy + fx * xx)
                out[k] += amp[0] * np.sin(phase) + amp[1] * np.cos(phase)
    return out


def make_synthetic_assets(seed: int = 0) -> dict:
    """Deterministic shape-exact stand-in for the Basel Face Model: a
    smooth face-like dome in 120x120 crop coordinates with smooth
    low-frequency deformation bases."""
    rng = np.random.default_rng(seed)

    H, W = GRID_H, GRID_W                 # 53,095 grid vertices
    n_grid = H * W
    vv, uu = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    x = 60.0 + 45.0 * (uu - 0.5) * 2.0 * np.sqrt(np.maximum(0.0, 1.0 - (2 * vv - 1) ** 2 * 0.35))
    y_img = 60.0 + 52.0 * (vv - 0.5) * 2.0
    r2 = ((uu - 0.5) * 2) ** 2 + ((vv - 0.5) * 2) ** 2
    z = 28.0 * np.exp(-1.6 * r2) - 8.0
    # Store y pre-flip: decode does y -> STD_SIZE + 1 - y.
    y = (STD_SIZE + 1) - y_img

    grid_verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)       # (n_grid, 3)
    extra_idx = rng.integers(0, n_grid, NVER - n_grid)
    verts = np.concatenate([grid_verts, grid_verts[extra_idx]], 0)  # (NVER, 3)
    u = verts.reshape(-1, 1).astype(np.float32)                    # (159645, 1)
    u_shp = u.copy()
    u_exp = np.zeros_like(u)

    def basis(n: int, scale: float, fseed: int) -> np.ndarray:
        frng = np.random.default_rng(fseed)
        fields = _smooth_field(frng, H, W, n * 3)
        fields = fields.reshape(n, 3, H * W).transpose(0, 2, 1)    # (n, grid, 3)
        fields = np.concatenate([fields, fields[:, extra_idx]], 1)  # (n, NVER, 3)
        flat = fields.reshape(n, -1).T                             # (159645, n)
        flat = flat / (np.linalg.norm(flat, axis=0, keepdims=True) + 1e-9)
        return (flat * scale).astype(np.float32)

    w_shp = basis(N_SHP, 120.0, seed + 1)
    w_exp = basis(N_EXP, 60.0, seed + 2)

    lm_rows = np.linspace(0.15, 0.9, 10)
    pts = []
    for i, rv in enumerate(lm_rows):
        ncol = [9, 5, 5, 9, 6, 6, 8, 8, 6, 6][i]
        for cu in np.linspace(0.2, 0.8, ncol):
            pts.append((rv, cu))
    pts = pts[:N_LMK]
    kp_vert = np.array([int(round(rv * (H - 1))) * W + int(round(cu * (W - 1)))
                        for rv, cu in pts], np.int64)
    keypoints = np.stack([kp_vert * 3, kp_vert * 3 + 1, kp_vert * 3 + 2],
                         1).reshape(-1).astype(np.int32)          # (204,)

    i0 = (np.arange(H - 1)[:, None] * W + np.arange(W - 1)[None, :]).ravel()
    t1 = np.stack([i0, i0 + 1, i0 + W], 0)
    t2 = np.stack([i0 + 1, i0 + W + 1, i0 + W], 0)
    tri = np.concatenate([t1, t2], 1)                              # (3, 105264)
    pad = NTRI - tri.shape[1]
    tri = np.concatenate([tri, tri[:, :pad]], 1).astype(np.int32)  # (3, 105840)

    param_mean = np.zeros(N_PARAM, np.float32)
    param_mean[:12] = np.array([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], np.float32)
    param_std = np.ones(N_PARAM, np.float32)
    param_std[:12] = np.array([.2, .1, .1, 6., .1, .2, .1, 6., .1, .1, .2, 2.],
                              np.float32)

    return {
        "u_shp": u_shp, "u_exp": u_exp, "w_shp": w_shp, "w_exp": w_exp,
        "keypoints": keypoints, "param_mean": param_mean,
        "param_std": param_std, "tri": tri,
    }


def load(root: str, seed: int = 0) -> dict:
    """The pack's arrays, from the cache under ``root/build/perfbench``
    or made (and cached, atomically) when it is missing."""
    path = os.path.join(root, "build", "perfbench",
                        f"bfm_synth_seed{seed}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in KEYS}
    d = make_synthetic_assets(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.npz"
    np.savez(tmp, **{k: d[k] for k in KEYS})
    os.replace(tmp, path)
    return d
