"""Fused s2d8 stem (conv1 + 3x3/2 max-pool): the CUDA kernel and its twin.

Counterpart of ``synergynet_tpu/detect/stem_pallas.py``, whose Pallas TPU
kernel ``_stem_kernel`` this replaces with ``csrc/stem_s2d8.cu``. Both
compute, over the (B, H8, W8, 192) space-to-depth(8) frame, the 2x2 conv
into the four stride-4 phases of 48 channels (f32 accumulation), + bias,
ReLU, and the 3x3/2 max-pool as a phase-shifted max with a zero halo
(:func:`~synergynet_tpu_torch.detect.net.phase_maxpool_s2d8`), rounded to
the input's dtype once at the end, in bf16 or f32 as the JAX kernel runs
in its input's dtype. The 4x-phase conv activation stays in the kernel's
shared memory.

The JAX kernel's row-band budget and its fallback to the XLA stem exist
because VMEM is small; the Hopper kernel takes any H8 and W8.

:func:`fused_stem1_s2d8` launches the kernel on a CUDA tensor, or raises;
on a CPU tensor it runs the plain twin :func:`fused_stem1_s2d8_reference`.
``fused_stem1_s2d8.launches`` counts the launches of the bf16 entry and
``fused_stem1_s2d8.launches_f32`` those of the f32 entry.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from synergynet_tpu_torch.detect.net import phase_maxpool_s2d8
from synergynet_tpu_torch.mm3d.codec import full_fp32
from synergynet_tpu_torch.ops.cuda_build import (check_tensor,
                                                 kernel_entry,
                                                 require_sm90)

CIN = 192
COUT = 48
DTYPES = (torch.bfloat16, torch.float32)


def taps_from_oihw(weight: torch.Tensor) -> torch.Tensor:
    """The port's OIHW stem weight (4*cout, C, 2, 2) -> the kernel's
    (4, C, 4*cout) ``[2a+b, cin, conv channel]``, which is JAX's
    ``kernel.reshape(4, c, 4 * cout)`` of the HWIO (2, 2, C, 4*cout)
    kernel."""
    o, c = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(4, c, o).contiguous()


def fused_stem1_s2d8_reference(x: torch.Tensor, weight4: torch.Tensor,
                               bias: torch.Tensor, cout: int = COUT
                               ) -> torch.Tensor:
    """The plain PyTorch twin, on any device: the conv in f32 on the
    input's values with TF32 off, + bias, ReLU, the phase max-pool, then a
    cast to ``x``'s dtype. (B, H8, W8, C) -> (B, H8, W8, cout)."""
    c = x.shape[-1]
    w = weight4.float().reshape(2, 2, c, 4 * cout).permute(3, 2, 0, 1)
    xf = x.float().permute(0, 3, 1, 2)
    with full_fp32():
        y = F.conv2d(F.pad(xf, (1, 0, 1, 0)), w, bias.float())
    out = phase_maxpool_s2d8(F.relu(y), cout)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _launch(x: torch.Tensor, weight4: torch.Tensor, bias: torch.Tensor
            ) -> torch.Tensor:
    """Check what the kernel takes, allocate the output, launch the entry
    of ``x``'s dtype on the current stream. Raises on anything else; never
    falls back."""
    dev = x.device
    check_tensor("x", x, DTYPES, (None, None, None, CIN), dev)
    check_tensor("weight4", weight4, (x.dtype,), (4, CIN, 4 * COUT), dev)
    check_tensor("bias", bias, (torch.float32, torch.bfloat16), (4 * COUT,),
                 dev)
    b, h8, w8, _ = x.shape
    if x.numel() >= 2 ** 31:
        raise ValueError(f"input {tuple(x.shape)} exceeds the kernel's "
                         "32-bit extents")
    for name, t in (("x", x), ("weight4", weight4)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    require_sm90(dev, "stem")
    f32 = x.dtype == torch.float32
    fn = kernel_entry("stem_s2d8",
                      "synergy_stem_s2d8_f32" if f32 else "synergy_stem_s2d8",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p])
    bias32 = bias.float().contiguous()
    out = torch.empty((b, h8, w8, COUT), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), weight4.data_ptr(), bias32.data_ptr(),
                out.data_ptr(), b, h8, w8, stream)
    if rc != 0:
        raise RuntimeError(f"stem kernel launch failed: CUDA error {rc}")
    if f32:
        fused_stem1_s2d8.launches_f32 += 1
    else:
        fused_stem1_s2d8.launches += 1
    return out


def fused_stem1_s2d8(x: torch.Tensor, weight4: torch.Tensor,
                     bias: torch.Tensor, cout: int = COUT) -> torch.Tensor:
    """(B, H8, W8, 192) s2d8 frames + (4, 192, 4*cout) tap weights (see
    :func:`taps_from_oihw`) + (4*cout,) bias -> (B, H8, W8, cout) pooled
    stem output, NHWC, in ``x``'s dtype, bf16 or f32 (any other raises). On
    a CUDA tensor the kernel ``csrc/stem_s2d8.cu`` (cout = 48): its bf16
    entry, counted in ``fused_stem1_s2d8.launches``, or its f32 entry,
    counted in ``fused_stem1_s2d8.launches_f32``; or an error. On a CPU
    tensor the plain twin."""
    if x.dtype not in DTYPES:
        raise TypeError(f"x is {x.dtype}; the stem takes one of {DTYPES}")
    if x.device.type == "cuda":
        if cout != COUT:
            raise ValueError(f"the stem kernel is built for cout={COUT}, "
                             f"got {cout}")
        return _launch(x, weight4, bias)
    if x.device.type == "cpu":
        return fused_stem1_s2d8_reference(x, weight4, bias, cout)
    raise ValueError(f"no stem kernel for device {x.device}")


fused_stem1_s2d8.launches = 0
fused_stem1_s2d8.launches_f32 = 0
