"""Shaded-surface synthetic crops: a dense appearance the backbone can learn.

Counterpart of ``synergynet_tpu/data/shaded.py``. The dot-painted crops of
:mod:`synergynet_tpu_torch.data.synthetic` carry signal in 68 2x2 dots
only; here the crop is a lit blob-surface render keyed to the 68 ground
truth landmarks, plus the same dots, so shading gradients across the face
region constrain pose, shape and expression densely.

The render is scatter-free. A 2-D isotropic Gaussian splat is separable,

    F_c(y, x) = sum_k payload[k, c] * gy[k, y] * gx[k, x],

so the coverage, a depth field and a per-landmark albedo tint (five
payload channels) are one ``torch.bmm`` of (B, H, K) x (B, K, 5 W) for a
batch. Normals are finite differences of the depth field, the dots an
outer product of 0/1 indicator profiles (exact). The products run in
full fp32 (TF32 would move pixels).

Randomness: each crop's light direction, background level and background
noise are keyed draws (:mod:`synergynet_tpu_torch.data.keyed`) of
``(key, crop index)``, so a crop is the same whatever batch it is rendered
in and whichever device renders it, up to the fp32 rounding of the render
itself. The draws are the port's own, not JAX's threefry: the same seed
gives other lighting and noise than the JAX package, with the same
distributions (light x/y uniform in [-0.6, 0.6), base in [40, 90), noise
in [0, 30)).

The materializing and streaming paths (:func:`make_shaded_crops` and
``GeneratedCropDataset``) render on the device they are given, the card
unless the caller asks for the CPU (the Trainer passes its own), in padded
batches of exactly :data:`RENDER_CHUNK` crops after decoding landmarks in
unpadded :data:`DECODE_CHUNK` rows, so the two paths give the same uint8
pixels for the same (seed, index) on one device. The generative resident
epoch (:func:`synergynet_tpu_torch.train.resident.fit_resident_generative`)
renders each batch on the card inside the epoch.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.data import keyed
from synergynet_tpu_torch.mm3d import ParamPack, decode_landmarks
from synergynet_tpu_torch.mm3d.assets import STD_SIZE
from synergynet_tpu_torch.mm3d.codec import full_fp32

# The one host render batch: both host paths render in batches of exactly
# this many crops, so a crop's pixels do not depend on the path.
RENDER_CHUNK = 256
# Both host paths decode landmarks in unpadded chunks of this many rows.
DECODE_CHUNK = 65536

# Lambertian shading: BGR albedo, ambient + diffuse sum to 1.
ALBEDO_BGR = (150.0, 180.0, 235.0)
AMBIENT = 0.45
DIFFUSE = 0.55
DOT_BGR = (255, 220, 180)      # landmark dot colour (data/synthetic.py)

SIGMA = 6.0          # blob radius (px): ~inter-landmark spacing in a crop
FIELD_EPS = 0.05     # normalizer floor: fields decay to 0 off-coverage
ALPHA_KNEE = 0.25    # cover at which the surface is 50% opaque
Z_RELIEF = 0.35      # depth-field scale feeding the shading normals

# Sub-streams of a render key: light, background level, background noise.
_LIGHT, _BASE, _NOISE = 0, 1, 2


@functools.lru_cache(maxsize=4)
def _tint(k: int) -> np.ndarray:
    """Fixed per-landmark albedo tints in [0.55, 1), (k, 3) float32."""
    return np.random.default_rng(7).uniform(0.55, 1.0, (k, 3)
                                            ).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _on_device(name: str, device: torch.device, k: int = 68
               ) -> torch.Tensor:
    """The tints (K, 3), the albedo (3,) or the dot colour (3,) uint8 on
    ``device``, made once per device: a tensor made on the host is a
    blocking copy to the card, which the training step must not make."""
    if name == "tint":
        return torch.from_numpy(_tint(k)).to(device)
    if name == "albedo":
        return torch.tensor(ALBEDO_BGR, dtype=torch.float32, device=device)
    return torch.tensor(DOT_BGR, dtype=torch.uint8, device=device)


def _axis_gauss(centers: torch.Tensor, size: int) -> torch.Tensor:
    """1-D Gaussian profiles: (B, K) centers -> (B, K, size).

    The exponential runs in float64 and rounds to float32: the CPU's
    vectorized and scalar float32 ``exp`` differ in the last bit, and which
    one an element gets depends on where the thread split falls, so a
    float32 ``exp`` would make a crop's pixels depend on its batch."""
    px = torch.arange(size, dtype=torch.float32, device=centers.device)
    d = px - centers[..., None]
    return torch.exp((d * d * (-0.5 / (SIGMA * SIGMA))).double()).float()


def _blob_fields(lmk: torch.Tensor, size: int):
    """(B, 3, K) crop-space landmarks -> ``cover`` (B, H, W), ``zfield``
    (B, H, W), ``tint`` (B, H, W, 3): the separable Gaussian splat as one
    batched product. ``zfield`` and ``tint`` are cover-normalized blends
    of the landmark depths and tints and decay to 0 off-coverage."""
    b, _, k = lmk.shape
    gx = _axis_gauss(lmk[:, 0], size)                        # (B, K, W)
    gy = _axis_gauss(lmk[:, 1], size)                        # (B, K, H)
    tint = _on_device("tint", lmk.device, k)
    payload = torch.cat([torch.ones((b, k, 1), device=lmk.device),
                         lmk[:, 2, :, None],
                         tint.expand(b, k, 3)], dim=2)       # (B, K, 5)
    rhs = (payload[..., None] * gx[:, :, None, :]).reshape(b, k, 5 * size)
    with full_fp32():
        fields = torch.bmm(gy.transpose(1, 2), rhs)          # (B, H, 5 W)
    fields = fields.reshape(b, size, 5, size)
    cover = fields[:, :, 0]
    norm = cover + FIELD_EPS
    zfield = fields[:, :, 1] / norm
    tint = fields[:, :, 2:5].permute(0, 1, 3, 2) / norm[..., None]
    return cover, zfield, tint


def _shade(zfield: torch.Tensor, tint: torch.Tensor, light: torch.Tensor
           ) -> torch.Tensor:
    """Lambertian shading of the depth field: finite-difference normals of
    (B, H, W), light (B, 3) -> float BGR colours (B, H, W, 3)."""
    zs = zfield * Z_RELIEF
    dzdy, dzdx = torch.gradient(zs, dim=(1, 2), edge_order=1)
    inv = torch.rsqrt(dzdx * dzdx + dzdy * dzdy + 1.0)
    lx, ly, lz = (light[:, i, None, None] for i in range(3))
    ndotl = (-dzdx * lx - dzdy * ly + lz) * inv
    inten = AMBIENT + DIFFUSE * torch.clamp_min(ndotl, 0.0)
    albedo = _on_device("albedo", zfield.device)
    return inten[..., None] * albedo * tint


def _dot_mask(lmk: torch.Tensor, size: int) -> torch.Tensor:
    """Exact 2x2 landmark-dot mask (B, H, W) bool: rounded (half to even),
    clipped to [0, size - 2], each dot covering (y..y+1, x..x+1); the
    union is one product of 0/1 indicator profiles."""
    px = torch.arange(size, device=lmk.device)

    def indicator(c):
        c = torch.clamp(torch.round(c).to(torch.int64), 0, size - 2)
        c = c[..., None]
        return ((px == c) | (px == c + 1)).to(torch.float32)   # (B, K, S)

    dxi, dyi = indicator(lmk[:, 0]), indicator(lmk[:, 1])
    with full_fp32():
        return torch.bmm(dyi.transpose(1, 2), dxi) > 0.5


def render_from(lmk: torch.Tensor, light: torch.Tensor, base: torch.Tensor,
                noise: torch.Tensor, size: int = STD_SIZE) -> torch.Tensor:
    """The render core, given its draws: landmarks (B, 3, K), unit light
    directions (B, 3) (:func:`light_from`), background levels (B, 3) and
    background noise (B, size, size, 3) (integers) -> (B, size, size, 3)
    BGR uint8."""
    cover, zfield, tint = _blob_fields(lmk, size)
    color = _shade(zfield, tint, light)
    alpha = (cover / (cover + ALPHA_KNEE))[..., None]
    bg = (base[:, None, None, :] + noise).to(torch.float32)
    out = alpha * color + (1.0 - alpha) * bg
    img = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    dot = _on_device("dot", lmk.device)
    return torch.where(_dot_mask(lmk, size)[..., None], dot, img)


def shaded_draws(key: int, idx: torch.Tensor, size: int = STD_SIZE):
    """Each crop's keyed draws, the same bits on any device: the light's
    x, y (B, 2) f32 uniform in [-0.6, 0.6), the background level (B, 3)
    in [40, 90) and the noise (B, size, size, 3) in [0, 30), int64."""
    lxy = keyed.uniform(keyed.make_key(key, _LIGHT), idx, 2, -0.6, 0.6)
    base = keyed.randint(keyed.make_key(key, _BASE), idx, 3, 40, 90)
    noise = keyed.randint(keyed.make_key(key, _NOISE), idx, size * size * 3,
                          0, 30).reshape(-1, size, size, 3)
    return lxy, base, noise


def light_from(lxy: torch.Tensor) -> torch.Tensor:
    """(B, 2) light x, y -> unit directions (x, y, 1) / norm, (B, 3)."""
    lx, ly = lxy[:, 0], lxy[:, 1]
    norm = torch.sqrt(lx * lx + ly * ly + 1.0)
    return torch.stack([lx, ly, torch.ones_like(lx)], dim=1) / norm[:, None]


def _render_shaded(lmk: torch.Tensor, key: int,
                   idx: Optional[torch.Tensor] = None,
                   size: int = STD_SIZE) -> torch.Tensor:
    """GT landmarks (B, 3, K) -> (B, size, size, 3) BGR uint8 crops, each
    lit and backed by the keyed draws of ``(key, idx[b])`` (``idx``
    defaults to 0..B-1), on the landmarks' device."""
    if idx is None:
        idx = torch.arange(lmk.shape[0], device=lmk.device)
    lxy, base, noise = shaded_draws(key, idx.to(lmk.device), size)
    return render_from(lmk, light_from(lxy), base, noise, size)


def render_shaded_crops(params: torch.Tensor, pack: ParamPack, key: int,
                        idx: Optional[torch.Tensor] = None,
                        size: int = STD_SIZE) -> torch.Tensor:
    """Whitened (B, 62) params -> (B, size, size, 3) BGR uint8 crops on the
    params' device (``pack`` on the same device)."""
    return _render_shaded(decode_landmarks(params, pack), key, idx, size)


def decode_chunked(params: np.ndarray, pack: ParamPack,
                   device) -> np.ndarray:
    """(n, 62) -> (n, 3, 68) landmarks decoded on ``device`` in unpadded
    :data:`DECODE_CHUNK` rows (the shared decode of both data paths)."""
    dev = torch.device(device)
    pk = pack.to(dev)
    out = np.empty((len(params), 3, len(pack.keypoints) // 3), np.float32)
    with torch.no_grad():
        for s in range(0, len(params), DECODE_CHUNK):
            p = torch.from_numpy(params[s:s + DECODE_CHUNK]).to(dev)
            out[s:s + len(p)] = decode_landmarks(p, pk).cpu().numpy()
    return out


def render_chunked(lmk: np.ndarray, idx: np.ndarray, key: int,
                   device) -> np.ndarray:
    """Render of (n, 3, K) host landmarks keyed by ``idx`` in padded
    batches of exactly :data:`RENDER_CHUNK` crops on ``device`` ->
    (n, 120, 120, 3) host uint8 (the shared render of both data paths)."""
    dev = torch.device(device)
    n = len(idx)
    out = np.empty((n, STD_SIZE, STD_SIZE, 3), np.uint8)
    with torch.no_grad():
        for s in range(0, n, RENDER_CHUNK):
            e = min(s + RENDER_CHUNK, n)
            rows = np.concatenate([np.arange(s, e),
                                   np.full(RENDER_CHUNK - (e - s), s)])
            img = _render_shaded(torch.from_numpy(lmk[rows]).to(dev), key,
                                 torch.from_numpy(idx[rows]).to(dev))
            out[s:e] = img[:e - s].cpu().numpy()
    return out


def make_shaded_crops(n: int, pack: Optional[ParamPack] = None,
                      seed: int = 0, device="cuda") -> Dict[str, np.ndarray]:
    """n shaded (crop, param62) pairs + decoded GT landmarks, the contract
    of ``synthetic.make_crops_with_params``: ``{"images" (n, 120, 120, 3)
    uint8, "params" (n, 62) f32, "landmarks" (n, 3, 68) f32}``; n = 0
    gives empty arrays of those shapes. Crop i is keyed by
    ``(make_key(seed), i)``, as the streaming dataset keys it; decode and
    render run on ``device``."""
    from synergynet_tpu_torch.data.synthetic import sample_params
    from synergynet_tpu_torch.mm3d import load_param_pack

    device = resolve_device(device)
    pack = pack or load_param_pack()
    params = sample_params(np.random.default_rng(seed), n)
    lmk = decode_chunked(params, pack, device)
    images = render_chunked(lmk, np.arange(n), keyed.make_key(seed), device)
    return {"images": images, "params": params, "landmarks": lmk}
