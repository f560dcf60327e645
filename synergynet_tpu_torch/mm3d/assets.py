"""3DMM asset pack: Basel Face Model PCA bases, whitening stats, topology.

Counterpart of ``synergynet_tpu/mm3d/assets.py``. The arrays are built and
cached with numpy exactly as there — :func:`make_synthetic_assets` is a
byte-identical copy of the JAX package's generator, and
:func:`load_param_pack` shares its ``assets/bfm_synth.npz`` cache — and
:class:`ParamPack` then holds them as CPU tensors; ``pack.to(device)`` moves
every leaf. :func:`convert_reference_assets` and :func:`convert_raw_bfm`
turn the reference's own files (its ``3dmm_data/`` directory, or a raw
Basel Face Model ``.mat``) into the same asset dict, which
:func:`save_assets_npz` writes for ``$SYNERGY_BFM``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.core.paths import asset_dir

NVER = 53_215          # dense mesh vertices
NTRI = 105_840         # triangles
N_SHP = 40             # shape PCA coefficients
N_EXP = 10             # expression PCA coefficients
N_POSE = 12            # flattened 3x4 camera matrix
N_PARAM = N_POSE + N_SHP + N_EXP  # 62
N_LMK = 68             # sparse landmarks
STD_SIZE = 120         # canonical crop size

# Synthetic-pack vertex grid (see make_synthetic_assets).
GRID_H = 205
GRID_W = 259

_ASSET_KEYS = (
    "u_shp", "u_exp", "w_shp", "w_exp", "keypoints", "param_mean",
    "param_std", "tri",
)


class ParamPack(NamedTuple):
    """Immutable 3DMM parameter pack with tensor leaves."""

    u: torch.Tensor            # (159645, 1) = u_shp + u_exp
    w_shp: torch.Tensor        # (159645, 40)
    w_exp: torch.Tensor        # (159645, 10)
    u_base: torch.Tensor       # (204, 1)   68-landmark rows of u
    w_shp_base: torch.Tensor   # (204, 40)
    w_exp_base: torch.Tensor   # (204, 10)
    param_mean: torch.Tensor   # (62,)
    param_std: torch.Tensor    # (62,)
    keypoints: torch.Tensor    # (204,) int32
    tri: torch.Tensor          # (3, 105840) int32, 0-based

    @property
    def nver(self) -> int:
        return self.u.shape[0] // 3

    @property
    def ntri(self) -> int:
        return self.tri.shape[1]

    def to(self, device) -> "ParamPack":
        return ParamPack(*(x.to(device) for x in self))


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
    """Deterministic shape-exact stand-in for the missing BFM data: a smooth
    face-like dome in 120x120 crop coordinates with smooth low-frequency
    deformation bases. Byte-identical to the JAX package's generator
    (``synergynet_tpu/mm3d/assets.py:104-181``)."""
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


def convert_reference_assets(d: str) -> dict:
    """The reference's ``3dmm_data/`` directory -> the asset dict: npy
    bases and a pickled whitening dict (reference utils/params.py:12-24),
    and ``tri.mat``'s 1-based 3 x T triangles made 0-based when present
    (model_building.py:68; else no triangles). The pickle is unpickled
    whole: load only trusted data."""
    import pickle

    def _load(p):
        if p.endswith(".npy"):
            return np.load(p)
        with open(p, "rb") as f:
            return pickle.load(f)

    out = {
        "u_shp": _load(os.path.join(d, "u_shp.npy")).astype(np.float32),
        "u_exp": _load(os.path.join(d, "u_exp.npy")).astype(np.float32),
        "w_shp": _load(os.path.join(d, "w_shp_sim.npy")).astype(np.float32),
        "w_exp": _load(os.path.join(d, "w_exp_sim.npy")).astype(np.float32),
        "keypoints": _load(os.path.join(d, "keypoints_sim.npy")).astype(
            np.int32),
    }
    meta = _load(os.path.join(d, "param_whitening.pkl"))
    out["param_mean"] = np.asarray(meta["param_mean"], np.float32)
    out["param_std"] = np.asarray(meta["param_std"], np.float32)
    tri_path = os.path.join(d, "tri.mat")
    if os.path.exists(tri_path):
        import scipy.io as sio
        out["tri"] = (sio.loadmat(tri_path)["tri"] - 1).astype(np.int32)
    else:
        out["tri"] = np.zeros((3, 0), np.int32)
    return out


def convert_raw_bfm(mat_path: str, param_whitening_path: str | None = None,
                    tri_path: str | None = None, n_shp: int = N_SHP,
                    n_exp: int = N_EXP) -> dict:
    """A raw Basel Face Model ``.mat`` (the ``model_refine`` layout) -> the
    asset dict, by the reference's ``load_bfm`` recipe (utils/io.py:58-104):
    the shape basis cut to ``n_shp`` columns and the expression basis to
    ``n_exp``, triangles and keypoints made 0-based, and each of the 68
    keypoints expanded to its interleaved (3k, 3k+1, 3k+2) rows. Triangles
    come from ``tri_path``, else the model's own ``tri``, else none; the
    whitening stats from ``param_whitening_path`` (a trusted pickle), else
    an identity camera mean and unit deviations."""
    import pickle

    import scipy.io as sio

    model = sio.loadmat(mat_path)["model_refine"][0, 0]
    w_shp = model["w"].astype(np.float32)[:, :n_shp]
    w_exp = model["w_exp"].astype(np.float32)[:, :n_exp]
    u_shp = model["mu_shape"].astype(np.float32).reshape(-1, 1)
    u_exp = model["mu_exp"].astype(np.float32).reshape(-1, 1)

    kp = model["keypoints"].astype(np.int64) - 1
    keypoints = np.concatenate(
        (3 * kp, 3 * kp + 1, 3 * kp + 2), axis=0).T.flatten().astype(np.int32)

    out = {
        "u_shp": u_shp, "u_exp": u_exp, "w_shp": w_shp, "w_exp": w_exp,
        "keypoints": keypoints,
    }
    if tri_path:
        out["tri"] = (sio.loadmat(tri_path)["tri"] - 1).astype(np.int32)
    elif "tri" in model.dtype.names:
        out["tri"] = (model["tri"].astype(np.int64) - 1).astype(np.int32)
    else:
        out["tri"] = np.zeros((3, 0), np.int32)
    if param_whitening_path:
        with open(param_whitening_path, "rb") as f:
            meta = pickle.load(f)
        out["param_mean"] = np.asarray(meta["param_mean"], np.float32)
        out["param_std"] = np.asarray(meta["param_std"], np.float32)
    else:
        out["param_mean"] = np.zeros(N_PARAM, np.float32)
        out["param_mean"][:12] = np.array(
            [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], np.float32)
        out["param_std"] = np.ones(N_PARAM, np.float32)
    return out


def device_pack(pack: ParamPack, device="cuda") -> ParamPack:
    """The pack with every leaf on ``device`` (the card unless the caller
    asks for the CPU): ``pack.to`` on a resolved device."""
    return pack.to(resolve_device(device))


def pack_from_arrays(d: dict) -> ParamPack:
    """Derive the full pack (base sub-bases, u = u_shp + u_exp) as CPU
    tensors."""
    u = (d["u_shp"] + d["u_exp"]).astype(np.float32).reshape(-1, 1)
    kp = d["keypoints"].astype(np.int32)
    arrays = (
        u,
        d["w_shp"].astype(np.float32),
        d["w_exp"].astype(np.float32),
        u[kp].reshape(-1, 1),
        d["w_shp"][kp].astype(np.float32),
        d["w_exp"][kp].astype(np.float32),
        d["param_mean"][:N_PARAM].astype(np.float32),
        d["param_std"][:N_PARAM].astype(np.float32),
        kp,
        d["tri"].astype(np.int32),
    )
    return ParamPack(*(torch.from_numpy(np.ascontiguousarray(a))
                       for a in arrays))


def save_assets_npz(path: str, d: dict) -> None:
    np.savez_compressed(path, **{k: d[k] for k in _ASSET_KEYS})


def load_assets_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in _ASSET_KEYS}


_PACK_CACHE: dict = {}


def load_param_pack(path: str | None = None, *,
                    synthetic_seed: int = 0) -> ParamPack:
    """Resolve the asset pack: explicit path > $SYNERGY_BFM > the cached
    synthetic pack ``<assets>/bfm_synth.npz``, generated and written once
    (atomically) when missing — the same file the JAX package reads."""
    default = os.path.join(asset_dir(), "bfm_synth.npz")
    key = path or os.environ.get("SYNERGY_BFM") or default
    if key in _PACK_CACHE:
        return _PACK_CACHE[key]
    if os.path.exists(key):
        pack = pack_from_arrays(load_assets_npz(key))
    elif key == default:
        d = make_synthetic_assets(seed=synthetic_seed)
        os.makedirs(os.path.dirname(key), exist_ok=True)
        # np.savez appends ".npz" unless the name already ends with it.
        tmp = key + f".tmp{os.getpid()}.npz"
        save_assets_npz(tmp, d)
        os.replace(tmp, key)
        pack = pack_from_arrays(d)
    else:
        raise FileNotFoundError(f"3DMM asset bundle not found: {key}")
    _PACK_CACHE[key] = pack
    return pack
