"""Fused dense 3DMM decode: the hand-written CUDA kernel and its plain twin.

Counterpart of ``synergynet_tpu/ops/fused_decode.py``. The dense decode is,
per face: de-whiten -> a (50,) x (50, 3N) basis product -> 3x3 rotation +
offset -> image-space y flip. The basis is laid out coordinate-split, as
in the JAX package: ``w`` (3, Npad, 50) for x, y, z and means ``u``
(3, Npad), Npad the vertex count rounded up to 128.

:func:`decode_dense_fused` de-whitens and parses on the tensor's device
(the tiny (B, 62) prologue stays outside the kernel, as in the JAX
package), then launches ``csrc/fused_decode.cu`` on a CUDA tensor — or
raises — and runs the plain twin :func:`decode_dense_fused_reference` on a
CPU tensor. ``decode_dense_fused.launches`` counts kernel launches.
:func:`decode_dense_fast` is the same decode on a basis built once per
pack (:func:`get_decode_basis`).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple, Tuple

import numpy as np
import torch

from synergynet_tpu_torch.mm3d.assets import ParamPack, STD_SIZE
from synergynet_tpu_torch.mm3d.codec import dewhiten, full_fp32
from synergynet_tpu_torch.ops.cuda_build import (check_tensor,
                                                 kernel_entry,
                                                 require_sm90)

LANE = 128
N_COEF = 50
FEW_FACES = 8       # the few-faces tiling's face tile (csrc/fused_decode.cu)


class DecodeBasis(NamedTuple):
    """Coordinate-separated, lane-padded dense basis."""

    w: torch.Tensor      # (3, Npad, 50)  [x, y, z] stacked
    u: torch.Tensor      # (3, Npad)
    nver: int            # true vertex count (<= Npad)

    @property
    def npad(self) -> int:
        return self.w.shape[1]

    def to(self, device) -> "DecodeBasis":
        return DecodeBasis(self.w.to(device), self.u.to(device), self.nver)


def build_decode_basis(pack: ParamPack) -> DecodeBasis:
    """Re-layout the pack's interleaved (3N, 50) basis once, as CPU
    tensors: row 3v + c of the pack becomes ``w[c, v]``."""
    w = np.concatenate([pack.w_shp.cpu().numpy(), pack.w_exp.cpu().numpy()],
                       axis=1)                       # (3N, 50)
    u = pack.u.cpu().numpy()[:, 0]                   # (3N,)
    n = w.shape[0] // 3
    npad = ((n + LANE - 1) // LANE) * LANE
    w3 = np.zeros((3, npad, N_COEF), np.float32)
    u3 = np.zeros((3, npad), np.float32)
    for k in range(3):                               # x, y, z rows
        w3[k, :n] = w[k::3]
        u3[k, :n] = u[k::3]
    return DecodeBasis(w=torch.from_numpy(w3), u=torch.from_numpy(u3),
                       nver=n)


def _prologue(param: torch.Tensor, pack: ParamPack
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whitened (B, 62) -> contiguous alpha (B, 50), p9 (B, 9), off (B, 3)."""
    raw = dewhiten(param, pack)
    p12 = raw[:, :12].reshape(-1, 3, 4)
    return (raw[:, 12:62].contiguous(),
            p12[:, :, :3].reshape(-1, 9).contiguous(),
            p12[:, :, 3].contiguous())


def _decode_plain(alpha, p9, off, basis: DecodeBasis) -> torch.Tensor:
    n = basis.nver
    with full_fp32():
        xyz = torch.matmul(basis.w[:, :n], alpha.T)          # (3, N, B)
        xyz = xyz.permute(2, 0, 1) + basis.u[None, :, :n]    # (B, 3, N)
        out = torch.bmm(p9.reshape(-1, 3, 3), xyz) + off[:, :, None]
    out[:, 1] = (STD_SIZE + 1) - out[:, 1]
    return out


def decode_dense_fused_reference(param: torch.Tensor, basis: DecodeBasis,
                                 pack: ParamPack) -> torch.Tensor:
    """The plain PyTorch twin of the kernel: whitened (B, 62) -> dense
    vertices (B, 3, nver), on any device, full fp32."""
    return _decode_plain(*_prologue(param, pack), basis)


def decode_variant(b: int) -> int:
    """The kernel's tiling for ``b`` faces: 0, few faces (one tile of
    ``FEW_FACES`` faces, bound by the basis read), for b <= FEW_FACES; 1,
    many faces (32-face register tiles, bound by the FMAs), above."""
    return 0 if b <= FEW_FACES else 1


def _launch(alpha, p9, off, basis: DecodeBasis) -> torch.Tensor:
    """Check what the kernel takes, allocate the output, launch on the
    current stream. Raises on anything else; never falls back."""
    dev = alpha.device
    b, nver, npad = alpha.shape[0], basis.nver, basis.npad
    expect = {"alpha": (alpha, (b, N_COEF)), "p9": (p9, (b, 9)),
              "off": (off, (b, 3)), "basis.w": (basis.w, (3, npad, N_COEF)),
              "basis.u": (basis.u, (3, npad))}
    for name, (t, shape) in expect.items():
        check_tensor(name, t, (torch.float32,), shape, dev)
    if not 0 < nver <= npad:
        raise ValueError(f"nver {nver} outside (0, npad={npad}]")
    if npad % 2 or basis.w.data_ptr() % 16:
        raise ValueError("the kernel stages the basis in 16-byte chunks: "
                         f"npad ({npad}) must be even and basis.w 16-byte "
                         "aligned")
    if b * 3 * nver >= 2 ** 31 or npad * 3 * N_COEF >= 2 ** 31:
        raise ValueError(f"batch {b} x {nver} vertices exceeds the kernel's "
                         "32-bit extents")
    require_sm90(dev, "fused-decode")
    fn = kernel_entry("fused_decode", "synergy_fused_decode",
                      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
    out = torch.empty((b, 3, nver), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(alpha.data_ptr(), p9.data_ptr(), off.data_ptr(),
                basis.w.data_ptr(), basis.u.data_ptr(), out.data_ptr(),
                b, nver, npad, decode_variant(b), stream)
    if rc != 0:
        raise RuntimeError(f"fused-decode kernel launch failed: CUDA error "
                           f"{rc}")
    decode_dense_fused.launches += 1
    return out


def decode_dense_fused(param: torch.Tensor, basis: DecodeBasis,
                       pack: ParamPack) -> torch.Tensor:
    """Whitened (B, 62) params -> dense vertices (B, 3, nver).

    Semantics of ``decode_dense`` (the codec). On a CUDA tensor it launches
    the sm_90a kernel ``csrc/fused_decode.cu`` (or raises); on a CPU tensor
    it runs the plain twin. ``pack`` supplies the whitening stats only.
    """
    alpha, p9, off = _prologue(param, pack)
    if param.device.type == "cuda":
        return _launch(alpha, p9, off, basis)
    if param.device.type == "cpu":
        return _decode_plain(alpha, p9, off, basis)
    raise ValueError(f"no fused decode for device {param.device}")


decode_dense_fused.launches = 0


# pack.w_shp's id -> (a weak reference to it, its basis on its device). The
# weak reference's callback drops the entry with the tensor, so an id
# reused by a later pack never finds an old basis.
_BASIS_CACHE: dict = {}


def get_decode_basis(pack: ParamPack) -> DecodeBasis:
    """The pack's coordinate-split basis on the pack's device, built once
    per pack (keyed by its ``w_shp`` tensor) and reused after."""
    key = id(pack.w_shp)
    hit = _BASIS_CACHE.get(key)
    if hit is not None and hit[0]() is pack.w_shp:
        return hit[1]
    basis = build_decode_basis(pack).to(pack.w_shp.device)
    ref = weakref.ref(pack.w_shp, lambda _, k=key: _BASIS_CACHE.pop(k, None))
    _BASIS_CACHE[key] = (ref, basis)
    return basis


def decode_dense_fast(param: torch.Tensor, pack: ParamPack) -> torch.Tensor:
    """Whitened (B, 62) params -> dense vertices (B, 3, nver):
    :func:`decode_dense_fused` on the pack's cached basis, so on a CUDA
    tensor it launches the kernel (or raises) and on a CPU tensor it runs
    the plain twin. ``param`` and ``pack`` share a device."""
    return decode_dense_fused(param, get_decode_basis(pack), pack)
