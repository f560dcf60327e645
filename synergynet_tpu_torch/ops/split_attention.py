"""ResNeSt's split-attention radix combine: kernel R1 and its plain twins.

A split-attention block (``nn/backbones/resnest.py::SplAtConv2d``) turns
its radix tensor ``y`` (B, r c, H, W), r branches of c channels, into one
(B, c, H, W) tensor in two steps, with Conv_1, BatchNorm_1, a ReLU and
Conv_2 between them:

- :func:`radix_pool` ``(y, radix)`` -> (B, c, 1, 1): the spatial mean of
  the sum over radix, the attention's input;
- :func:`radix_combine` ``(y, logits, radix, groups)`` -> (B, c, H, W):
  Conv_2's logits (B, r c, 1, 1), in the (cardinality, radix,
  c / cardinality) channel layout, become weights by a softmax over radix
  (a sigmoid when ``radix`` is 1), and the branches are summed under them.

On a CUDA tensor each launches its entry of R1 (``csrc/split_attention.cu``:
bf16 or f32, ``y`` channels-last and 16-byte aligned, c a multiple of 8 in
bf16 or 4 in f32) or raises; on a CPU tensor each runs its plain twin
(:func:`radix_pool_reference`, :func:`radix_combine_reference`: the block's
expressions as written before R1). R1 rounds where the twins round, so the
two differ only by the order of the spatial sum. Where autograd records the
call, R1 runs under a ``torch.autograd.Function`` whose backward is the
twin's, recomputed.
"""

from __future__ import annotations

import ctypes

import torch

from synergynet_tpu_torch.nn.layers import spatial_mean
from synergynet_tpu_torch.ops.cuda_build import (check_tensor, launch,
                                                 require_sm90)

# R1's weights (radix x c floats) live in 48 KB of shared memory. The C
# entries refuse the same shapes as ``_check_y`` (this limit is
# ``MAX_WEIGHTS`` in csrc/split_attention.cu, c a multiple of 16 bytes);
# the checks here stand first for their messages. A card test holds the
# two sides to one limit.
R1_MAX_WEIGHTS = 12288


def radix_pool_reference(y: torch.Tensor, radix: int) -> torch.Tensor:
    """The plain twin of :func:`radix_pool`."""
    b, rc, h, w = y.shape
    split = y.reshape(b, radix, rc // radix, h, w)
    return spatial_mean(split.sum(1), keepdim=True)


def radix_combine_reference(y: torch.Tensor, logits: torch.Tensor,
                            radix: int, groups: int) -> torch.Tensor:
    """The plain twin of :func:`radix_combine`."""
    b, rc, h, w = y.shape
    c = rc // radix
    if radix > 1:
        split = y.reshape(b, radix, c, h, w)
        atten = logits.reshape(b, groups, radix, c // groups)
        atten = torch.softmax(atten, dim=2).transpose(1, 2).reshape(
            b, radix, c, 1, 1)
        return (split * atten).sum(1)
    return y * torch.sigmoid(logits.reshape(b, c, 1, 1))


def _check_y(y: torch.Tensor, radix: int) -> int:
    """Raise unless R1 takes the radix tensor ``y``; -> c."""
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"y is {y.dtype}, kernel R1 takes bfloat16 or "
                        f"float32")
    if y.dim() != 4 or radix < 1 or y.shape[1] % radix:
        raise ValueError(f"y has shape {tuple(y.shape)}, expected (B, radix "
                         f"c, H, W) with radix {radix}")
    c = y.shape[1] // radix
    vec = 16 // y.element_size()
    if c % vec or radix * c > R1_MAX_WEIGHTS:
        raise ValueError(f"{c} channels a branch at radix {radix}: kernel R1 "
                         f"takes a multiple of {vec}, radix x c at most "
                         f"{R1_MAX_WEIGHTS}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("y is not channels-last contiguous")
    if y.data_ptr() % 16:
        raise ValueError("y is not 16-byte aligned")
    require_sm90(y.device, "split-attention")
    return c


def _pool(y: torch.Tensor, radix: int) -> torch.Tensor:
    """Check, allocate, launch R1's pool on the current stream. No host
    read and no synchronisation: safe under a CUDA graph capture."""
    c = _check_y(y, radix)
    b, _, h, w = y.shape
    out = torch.empty((b, c, 1, 1), dtype=y.dtype, device=y.device)
    if out.numel() and h * w:
        launch("split_attention", "synergy_splat_pool",
               [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5, y.device,
               y, out, b, h * w, radix, c, y.element_size())
    return out


def _combine(y: torch.Tensor, logits: torch.Tensor, radix: int,
             groups: int) -> torch.Tensor:
    """Check, allocate, launch R1's combine on the current stream."""
    c = _check_y(y, radix)
    b, _, h, w = y.shape
    if groups < 1 or c % groups:
        raise ValueError(f"{c} channels a branch do not split into {groups} "
                         f"groups")
    if logits.shape != (b, radix * c, 1, 1):
        raise ValueError(f"logits have shape {tuple(logits.shape)}, "
                         f"expected {(b, radix * c, 1, 1)}")
    flat = logits.view(b, radix * c)
    check_tensor("logits", flat, (y.dtype,), (b, radix * c), y.device)
    out = torch.empty((b, c, h, w), dtype=y.dtype, device=y.device,
                      memory_format=torch.channels_last)
    if out.numel():
        launch("split_attention", "synergy_splat_combine",
               [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6, y.device,
               y, flat, out, b, h * w, radix, c, groups, y.element_size())
    return out


class _Pool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, radix):
        ctx.save_for_backward(y)
        ctx.radix = radix
        return _pool(y, radix)

    @staticmethod
    def backward(ctx, grad):
        y, = ctx.saved_tensors
        with torch.enable_grad():
            y = y.detach().requires_grad_()
            out = radix_pool_reference(y, ctx.radix)
        return torch.autograd.grad(out, y, grad)[0], None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, logits, radix, groups):
        ctx.save_for_backward(y, logits)
        ctx.radix, ctx.groups = radix, groups
        return _combine(y, logits, radix, groups)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = radix_combine_reference(*inputs, ctx.radix, ctx.groups)
        return (*torch.autograd.grad(out, inputs, grad), None, None)


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def radix_pool(y: torch.Tensor, radix: int) -> torch.Tensor:
    """Radix tensor (B, radix c, H, W) -> (B, c, 1, 1) in its dtype: the
    spatial mean (f32 accumulation, rounded once) of the radix sum (rounded
    to the dtype at each position)."""
    if y.device.type == "cuda":
        return _Pool.apply(y, radix) if _records(y) else _pool(y, radix)
    if y.device.type == "cpu":
        return radix_pool_reference(y, radix)
    raise ValueError(f"no split-attention pool for device {y.device}")


def radix_combine(y: torch.Tensor, logits: torch.Tensor, radix: int,
                  groups: int) -> torch.Tensor:
    """Radix tensor (B, radix c, H, W) and Conv_2's logits (B, radix c, 1,
    1) -> (B, c, H, W) in their dtype (channels-last on a card): each branch
    times its rSoftmax (sigmoid at radix 1) weight, summed over radix."""
    if logits.device != y.device:
        raise ValueError(f"logits on {logits.device}, y on {y.device}")
    if y.device.type == "cuda":
        if _records(y, logits):
            return _Combine.apply(y, logits, radix, groups)
        return _combine(y, logits, radix, groups)
    if y.device.type == "cpu":
        return radix_combine_reference(y, logits, radix, groups)
    raise ValueError(f"no split-attention combine for device {y.device}")
