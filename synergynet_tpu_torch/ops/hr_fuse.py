"""One output of HRNet's exchange unit in one pass: kernel F1 and its plain
twin.

An exchange unit of ``nn/backbones/hrnet.py`` gives branch i
``relu(sum over j of f_ij(x_j))``: ``f_ii`` is the identity; for a branch
of higher resolution (j < i) the last of its stride-2 convs, then its
BatchNorm; for one of lower resolution (j > i) a 1x1 conv, its BatchNorm,
then a nearest upsample by 2^(j - i). :func:`hr_fuse` ``(identity,
terms)`` computes that sum from the identity ``x_i`` (B, C, H, W) and the
terms ``(raw conv output, its BatchNorm, scale)``, the raw output at
(H / scale, W / scale), scale 1, 2, 4 or 8, in the module's order of j:
the terms at scale 1 first, then the identity, then the upsampled terms,
added left to right.

- In train mode (a term's BatchNorm training) it runs the twin,
  :func:`hr_fuse_reference`, which calls the modules.
- In eval mode on a CUDA tensor it launches F1 (``csrc/hr_fuse.cu``: bf16
  or f32, every operand channels-last and 16-byte aligned, a row of C
  channels a multiple of 4 bytes, 1 to 3 terms, the BatchNorms' statistics
  and parameters f32) or raises; on a CPU tensor it runs the twin.

F1 agrees with the twin bit for bit on the card: it rounds where the twin
rounds (each term's ``F.batch_norm`` once to the type, each add once, the
ReLU exact) and adds in the twin's order. That was chosen over one
rounding of an f32 sum, which would sit within one bf16 step, because the
twin is the module's own expression and the kernel, bound by bytes,
follows it at no cost. Where autograd records the call, F1 runs under a
``torch.autograd.Function`` whose backward is the twin's, recomputed.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from synergynet_tpu_torch.ops.cuda_build import (check_tensor, launch,
                                                 require_sm90)

MAX_TERMS = 3           # a unit of four branches; MAX_TERMS in hr_fuse.cu
SCALES = (1, 2, 4, 8)

Term = Tuple[torch.Tensor, object, int]     # (raw, BatchNorm, scale)


def hr_fuse_reference(identity: torch.Tensor,
                      terms: Sequence[Term]) -> torch.Tensor:
    """The plain twin of :func:`hr_fuse`: each term's BatchNorm (the
    module), its nearest upsample, the adds left to right in the module's
    order of j, the ReLU."""
    ahead = [bn(raw) for raw, bn, s in terms if s == 1]
    after = [F.interpolate(bn(raw), scale_factor=s, mode="nearest")
             for raw, bn, s in terms if s != 1]
    order = ahead + [identity] + after
    y = order[0]
    for z in order[1:]:
        y = y + z
    return F.relu(y)


def _check_operand(name: str, t: torch.Tensor, shape, like) -> None:
    if t.dtype != like.dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, expected "
                         f"{like.dtype} {tuple(shape)}")
    if t.device != like.device:
        raise ValueError(f"{name} on {t.device}, the identity on "
                         f"{like.device}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} is not channels-last contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def check_hr_fuse(identity: torch.Tensor, terms: Sequence[Term]) -> int:
    """Raise unless F1 takes these operands (the card aside); -> the count
    of terms added ahead of the identity."""
    if identity.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"identity is {identity.dtype}, kernel F1 takes "
                        f"bfloat16 or float32")
    if identity.dim() != 4:
        raise ValueError(f"identity has shape {tuple(identity.shape)}, "
                         f"expected (B, C, H, W)")
    b, c, h, w = identity.shape
    if b * h * w >= 2 ** 31:
        raise ValueError(f"{b} x {h} x {w} rows: kernel F1 takes fewer than "
                         f"2^31")
    vec = 4 // identity.element_size()
    if c % vec:
        raise ValueError(f"{c} channels: kernel F1 takes a multiple of {vec} "
                         f"in {identity.dtype} (rows of 4-byte multiples)")
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"{len(terms)} terms: kernel F1 takes 1 to "
                         f"{MAX_TERMS}")
    scales = [s for _, _, s in terms]
    before = scales.count(1)
    if any(s != 1 for s in scales[:before]):
        raise ValueError(f"scales {scales}: the scale-1 terms come first")
    _check_operand("identity", identity, identity.shape, identity)
    for j, (raw, bn, s) in enumerate(terms):
        if s not in SCALES or h % s or w % s:
            raise ValueError(f"term {j}: scale {s} of {h} x {w}; F1 takes "
                             f"{SCALES} dividing the extent")
        _check_operand(f"term {j}", raw, (b, c, h // s, w // s), identity)
        if bn.channel_dim != 1:
            raise ValueError(f"term {j}'s BatchNorm normalises dim "
                             f"{bn.channel_dim}; F1 takes channels at dim 1")
        for part in ("running_mean", "running_var", "weight", "bias"):
            check_tensor(f"term {j} {part}", getattr(bn, part),
                         (torch.float32,), (c,), identity.device)
    return before


def _launch(identity: torch.Tensor, terms: Sequence[Term]) -> torch.Tensor:
    """Check, allocate, launch F1 on the current stream. No host read and
    no synchronisation: safe under a CUDA graph capture."""
    before = check_hr_fuse(identity, terms)
    require_sm90(identity.device, "exchange unit")
    out = torch.empty_like(identity, memory_format=torch.channels_last)
    if out.numel():
        slots = []
        for j in range(MAX_TERMS):
            if j < len(terms):
                raw, bn, s = terms[j]
                slots += [raw, bn.running_mean, bn.running_var, bn.weight,
                          bn.bias, float(bn.eps), s]
            else:
                slots += [None] * 5 + [0.0, 1]
        b, c, h, w = identity.shape
        launch("hr_fuse", "synergy_hr_fuse",
               [ctypes.c_void_p] * 2
               + ([ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_int])
               * MAX_TERMS + [ctypes.c_int] * 7, identity.device,
               identity, out, *slots, len(terms), before, b, h, w, c,
               identity.element_size())
    return out


class _HrFuse(torch.autograd.Function):
    """F1 forward; the twin's gradient, recomputed. Each term's raw output
    and affine parameters come in as arguments so that autograd routes
    their gradients."""

    @staticmethod
    def forward(ctx, identity, bns, scales, *flat):
        raws = flat[0::3]
        ctx.save_for_backward(identity, *raws)
        ctx.bns, ctx.scales = bns, scales
        return _launch(identity, list(zip(raws, bns, scales)))

    @staticmethod
    def backward(ctx, grad):
        identity, *raws = ctx.saved_tensors
        with torch.enable_grad():
            identity = identity.detach().requires_grad_()
            raws = [r.detach().requires_grad_() for r in raws]
            out = hr_fuse_reference(identity,
                                    list(zip(raws, ctx.bns, ctx.scales)))
        slots = [identity]
        for r, bn in zip(raws, ctx.bns):
            slots += [r, bn.weight, bn.bias]
        needs = [ctx.needs_input_grad[0]] + list(ctx.needs_input_grad[3:])
        wanted = [t for t, need in zip(slots, needs) if need]
        found = iter(torch.autograd.grad(out, wanted, grad))
        got = [next(found) if need else None for need in needs]
        return (got[0], None, None, *got[1:])


def hr_fuse(identity: torch.Tensor, terms: Sequence[Term]) -> torch.Tensor:
    """``relu`` of the identity and every term's ``up_s(bn(raw))`` added in
    the module's order, in the identity's dtype (channels-last on a card):
    F1 on a card in eval mode, else the twin (module doc)."""
    terms = list(terms)
    if any(bn.training for _, bn, _ in terms):
        return hr_fuse_reference(identity, terms)
    if identity.device.type == "cuda":
        flat = []
        for raw, bn, _ in terms:
            flat += [raw, bn.weight, bn.bias]
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (identity, *flat)):
            return _HrFuse.apply(identity, tuple(bn for _, bn, _ in terms),
                                 tuple(s for _, _, s in terms), *flat)
        return _launch(identity, terms)
    if identity.device.type == "cpu":
        return hr_fuse_reference(identity, terms)
    raise ValueError(f"no exchange unit for device {identity.device}")
