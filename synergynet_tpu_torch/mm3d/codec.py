"""62-parameter 3DMM codec: whitening, parsing, landmark/dense decode.

Counterpart of ``synergynet_tpu/mm3d/codec.py``, with its conventions:

- A 62-d parameter = [12 flattened 3x4 camera matrix | 40 shape | 10 expr]
  in whitened units; de-whitening is ``param * std[:62] + mean[:62]``.
- Vertices use the Fortran-order interleave: the 3N-vector is
  [x1, y1, z1, x2, ...], reshaped (N, 3) and transposed to (3, N).
- Image-space y flip: ``y -> STD_SIZE + 1 - y``.

Everything here is full fp32. The landmark decode is precision-sensitive
(the JAX package forces ``Precision.HIGHEST``, ``codec.py:35-40``), so the
products run with TF32 off.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import torch

from synergynet_tpu_torch.mm3d.assets import ParamPack, STD_SIZE


# The TF32 flags are process-wide, so ``full_fp32`` counts its holders
# across threads: the first to enter saves the flags and turns TF32 off,
# the last to leave restores them. The lock guards only the count and the
# flags, never the enclosed work.
_FP32_LOCK = threading.Lock()
_fp32_holders = 0
_fp32_saved: Tuple[bool, bool] = (False, False)


@contextlib.contextmanager
def full_fp32():
    """Run the enclosed products and convolutions in full fp32: TF32 off
    for cuBLAS (``torch.backends.cuda.matmul.allow_tf32``) and for cuDNN
    (``torch.backends.cudnn.allow_tf32``) while any thread is inside, and
    the values found before the first holder restored when the last one
    leaves. Nests, within a thread and across threads; entering and
    leaving wait on a module lock, the enclosed work does not."""
    global _fp32_holders, _fp32_saved
    with _FP32_LOCK:
        if _fp32_holders == 0:
            _fp32_saved = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _fp32_holders += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _fp32_holders -= 1
            if _fp32_holders == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _fp32_saved


def full_fp32_if(dtype: torch.dtype):
    """:func:`full_fp32` for a float32 net, a null context otherwise: the
    TF32 flags do not touch a bf16 net's convolutions, so its path takes
    no lock."""
    return full_fp32() if dtype == torch.float32 else contextlib.nullcontext()


def dewhiten(param: torch.Tensor, pack: ParamPack) -> torch.Tensor:
    """Whitened (B, 62) -> raw parameter units."""
    return param * pack.param_std[:62] + pack.param_mean[:62]


def whiten(param_raw: torch.Tensor, pack: ParamPack) -> torch.Tensor:
    """Raw (B, 62) parameters -> whitened units, the inverse of
    :func:`dewhiten`."""
    return (param_raw - pack.param_mean[:62]) / pack.param_std[:62]


def parse_param62(param_raw: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Split raw (B, 62) into (p (B,3,3), offset (B,3,1), alpha_shp (B,40,1),
    alpha_exp (B,10,1))."""
    p_ = param_raw[:, :12].reshape(-1, 3, 4)
    p = p_[:, :, :3]
    offset = p_[:, :, 3:]
    alpha_shp = param_raw[:, 12:52, None]
    alpha_exp = param_raw[:, 52:62, None]
    return p, offset, alpha_shp, alpha_exp


def _synth(u, w_shp, w_exp, alpha_shp, alpha_exp) -> torch.Tensor:
    """u + w_shp@a + w_exp@e for a batch, returned as (B, 3, N)."""
    alphas = torch.cat([alpha_shp[..., 0], alpha_exp[..., 0]], dim=1)
    w = torch.cat([w_shp, w_exp], dim=1)                    # (3N, 50)
    flat = u[:, 0] + alphas @ w.T                           # (B, 3N)
    n = flat.shape[1] // 3
    return flat.reshape(-1, n, 3).transpose(1, 2)           # (B, 3, N)


def decode_param62(param: torch.Tensor, pack: ParamPack, *, dense: bool,
                   whitening: bool = True, transform: bool = True
                   ) -> torch.Tensor:
    """Whitened (B, 62) params -> vertices (B, 3, 68) or (B, 3, 53215)."""
    param_raw = dewhiten(param, pack) if whitening else param
    p, offset, alpha_shp, alpha_exp = parse_param62(param_raw)
    with full_fp32():
        if dense:
            base = _synth(pack.u, pack.w_shp, pack.w_exp, alpha_shp,
                          alpha_exp)
        else:
            base = _synth(pack.u_base, pack.w_shp_base, pack.w_exp_base,
                          alpha_shp, alpha_exp)
        vertex = torch.matmul(p, base) + offset              # (B, 3, N)
    if transform:
        vertex[:, 1, :] = (STD_SIZE + 1) - vertex[:, 1, :]
    return vertex


def decode_landmarks(param: torch.Tensor, pack: ParamPack,
                     **kw) -> torch.Tensor:
    """(B, 62) -> 68 3D landmarks (B, 3, 68) in 120x120 crop space."""
    return decode_param62(param, pack, dense=False, **kw)


def decode_dense(param: torch.Tensor, pack: ParamPack, **kw) -> torch.Tensor:
    """(B, 62) -> dense mesh vertices (B, 3, 53215) in 120x120 crop space."""
    return decode_param62(param, pack, dense=True, **kw)


def rescale_to_roi(vertex: torch.Tensor, roi_box: torch.Tensor
                   ) -> torch.Tensor:
    """Map crop-space vertices (B, 3, N) into original-image coordinates.

    ``roi_box`` is (B, 4+) [sx, sy, ex, ey, ...]: x/y scale by roi extent /
    120 plus offset, z by the mean of the two factors. One broadcast
    multiply-add, so the (possibly 654 MB) vertex block is copied once.
    """
    sx, sy, ex, ey = (roi_box[:, i] for i in range(4))
    scale_x = (ex - sx) / STD_SIZE
    scale_y = (ey - sy) / STD_SIZE
    s = (scale_x + scale_y) / 2
    scale = torch.stack([scale_x, scale_y, s], dim=1)[:, :, None]
    shift = torch.stack([sx, sy, torch.zeros_like(sx)], dim=1)[:, :, None]
    return vertex * scale + shift
