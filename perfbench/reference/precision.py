"""The arithmetic of the reference: float32 with TF32 off, or the control's
fp8.

Every convolution and matrix product of the reference goes through one
:class:`Precision`. ``"f32"`` computes in float32 (the caller holds
:func:`exact_f32`, so cuBLAS and cuDNN do not drop to TF32). ``"fp8"`` is
the control: each operand of a product is rounded to float8 e4m3 under a
per-tensor scale (its largest magnitude maps to 448, e4m3's largest
finite value), as fp8 inference quantizes, and the product accumulates in
float32. Everything between the products stays float32 in both.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuBLAS and cuDNN inside the block; the flags as found
    afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Precision:
    """``kind`` "f32" or "fp8"."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand as the products see it."""
        x = x.float()
        if self.kind == "f32":
            return x
        scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def conv(self, x, w, b=None, stride=1, pad=0, groups=1):
        """NCHW ``x``, OIHW ``w``."""
        return F.conv2d(self.q(x), self.q(w), b, stride, pad, 1, groups)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def dense(self, x, kernel, bias):
        """flax ``Dense``: ``kernel`` (in, out)."""
        return self.matmul(x, kernel) + bias
