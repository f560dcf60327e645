"""A convolution's eval BatchNorm, residual add and ReLU / ReLU6 in one
pass: kernel BN1 and its plain twin.

:func:`bn_act` ``(x, bn, act, residual, residual_bn)`` computes
``act(bn(x) [+ r])`` for a conv output ``x`` (B, C, H, W): ``bn`` is a
:class:`~synergynet_tpu_torch.nn.batchnorm.BatchNorm` over the channels,
``act`` one of :data:`ACTS`, and ``r`` is absent, ``residual`` as it is
(an identity shortcut) or ``residual_bn(residual)`` (a projected shortcut).

- In train mode (``bn`` or ``residual_bn`` training) it runs the twin,
  :func:`bn_act_reference`, which calls the modules: their batch
  statistics and running updates, as the blocks computed before BN1.
- In eval mode on a CUDA tensor it launches BN1 (``csrc/bn_act.cu``: bf16
  or f32, ``x`` and ``residual`` channels-last and 16-byte aligned, a row
  of C channels a multiple of 4 bytes: any even C in bf16, any C in f32;
  the BatchNorms' statistics and parameters f32) or raises; on a CPU
  tensor it runs the twin.

BN1 rounds where the twin rounds on the card (``F.batch_norm`` once to the
tensor's type, the add once, the clamps exact), so the two agree bit for
bit there. Where autograd records the call, BN1 runs under a
``torch.autograd.Function`` whose backward is the twin's, recomputed.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from synergynet_tpu_torch.ops.cuda_build import (check_tensor, launch,
                                                 require_sm90)


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``minimum(relu(x), 6)`` as the JAX package writes it: at exactly 6
    the gradient splits half and half like ``jnp.minimum``'s, where
    ``F.relu6`` (hardtanh) passes none; 6.0 is common in bf16."""
    return torch.minimum(F.relu(x), torch.tensor(6.0, dtype=x.dtype))


# act -> (BN1's code, the twin's function)
ACTS = {"none": (0, lambda y: y), "relu": (1, F.relu), "relu6": (2, relu6)}


def bn_act_reference(x: torch.Tensor, bn, act: str = "none",
                     residual: Optional[torch.Tensor] = None,
                     residual_bn=None) -> torch.Tensor:
    """The plain twin of :func:`bn_act`: the blocks' expressions as written
    before BN1, through the modules (eval: ``F.batch_norm``)."""
    y = bn(x)
    if residual is not None:
        y = (residual if residual_bn is None else residual_bn(residual)) + y
    return ACTS[act][1](y)


def _check_bn(name: str, bn, c: int, device) -> None:
    if bn.channel_dim != 1:
        raise ValueError(f"{name} normalises dim {bn.channel_dim}; BN1 takes "
                         f"channels at dim 1")
    for part in ("running_mean", "running_var", "weight", "bias"):
        check_tensor(f"{name}.{part}", getattr(bn, part), (torch.float32,),
                     (c,), device)


def check_bn_act(x: torch.Tensor, bn, act: str,
                 residual: Optional[torch.Tensor] = None,
                 residual_bn=None) -> int:
    """Raise unless BN1 takes these operands (the card aside); -> C."""
    if act not in ACTS:
        raise ValueError(f"act {act!r}: BN1 takes one of {sorted(ACTS)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x is {x.dtype}, kernel BN1 takes bfloat16 or "
                        f"float32")
    if x.dim() != 4:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (B, C, H, "
                         f"W)")
    c = x.shape[1]
    vec = 4 // x.element_size()
    if c % vec:
        raise ValueError(f"{c} channels: kernel BN1 takes a multiple of "
                         f"{vec} in {x.dtype} (rows of 4-byte multiples)")
    operands = [("x", x)]
    if residual is not None:
        if residual.dtype != x.dtype or residual.shape != x.shape:
            raise ValueError(f"residual is {residual.dtype} "
                             f"{tuple(residual.shape)}, x {x.dtype} "
                             f"{tuple(x.shape)}")
        if residual.device != x.device:
            raise ValueError(f"residual on {residual.device}, x on "
                             f"{x.device}")
        operands.append(("residual", residual))
    elif residual_bn is not None:
        raise ValueError("residual_bn without a residual")
    for name, t in operands:
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name} is not channels-last contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    _check_bn("bn", bn, c, x.device)
    if residual_bn is not None:
        _check_bn("residual_bn", residual_bn, c, x.device)
    return c


def _stats(bn):
    if bn is None:
        return [None] * 4 + [0.0]
    return [bn.running_mean, bn.running_var, bn.weight, bn.bias,
            float(bn.eps)]


def _launch(x, bn, act, residual, residual_bn):
    """Check, allocate, launch BN1 on the current stream. No host read and
    no synchronisation: safe under a CUDA graph capture."""
    c = check_bn_act(x, bn, act, residual, residual_bn)
    require_sm90(x.device, "BatchNorm + activation")
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if out.numel():
        res = 0 if residual is None else 1 if residual_bn is None else 2
        launch("bn_act", "synergy_bn_act",
               [ctypes.c_void_p] * 7 + [ctypes.c_float]
               + [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_longlong]
               + [ctypes.c_int] * 4, x.device,
               x, residual, out, *_stats(bn), *_stats(residual_bn),
               out.numel() // c, c, ACTS[act][0], res, x.element_size())
    return out


class _BnAct(torch.autograd.Function):
    """BN1 forward; the twin's gradient, recomputed. The parameters come in
    as arguments so that autograd routes their gradients."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, weight2, bias2, bn, act,
                residual_bn):
        ctx.save_for_backward(x, residual)
        ctx.bn, ctx.act, ctx.residual_bn = bn, act, residual_bn
        return _launch(x, bn, act, residual, residual_bn)

    @staticmethod
    def backward(ctx, grad):
        x, residual = ctx.saved_tensors
        rbn = ctx.residual_bn
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            if residual is not None:
                residual = residual.detach().requires_grad_()
            out = bn_act_reference(x, ctx.bn, ctx.act, residual, rbn)
        slots = [x, residual, ctx.bn.weight, ctx.bn.bias,
                 None if rbn is None else rbn.weight,
                 None if rbn is None else rbn.bias]
        wanted = [t for t, need in zip(slots, ctx.needs_input_grad)
                  if need and t is not None]
        found = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(found) if need and t is not None else None
                  for t, need in zip(slots, ctx.needs_input_grad)),
                None, None, None)


def bn_act(x: torch.Tensor, bn, act: str = "none",
           residual: Optional[torch.Tensor] = None,
           residual_bn=None) -> torch.Tensor:
    """``act(bn(x) [+ r])`` in ``x``'s dtype (channels-last on a card), r
    being ``residual`` or ``residual_bn(residual)``: BN1 on a card in eval
    mode, else the twin (module doc)."""
    if bn.training or (residual_bn is not None and residual_bn.training):
        return bn_act_reference(x, bn, act, residual, residual_bn)
    if x.device.type == "cuda":
        params = [bn.weight, bn.bias]
        params += [None, None] if residual_bn is None else [
            residual_bn.weight, residual_bn.bias]
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, residual, *params)):
            return _BnAct.apply(x, residual, *params, bn, act, residual_bn)
        return _launch(x, bn, act, residual, residual_bn)
    if x.device.type == "cpu":
        return bn_act_reference(x, bn, act, residual, residual_bn)
    raise ValueError(f"no BatchNorm + activation for device {x.device}")


def bn_act_sites(model, x: torch.Tensor) -> List[Tuple]:
    """Every :func:`bn_act` call of one forward of ``model`` on ``x``, in
    order: (C, H, W, act, residual form), the form ``"none"``, ``"raw"`` or
    ``"bn"``. The backbones' ``bn_act`` is swapped for a tally that runs the
    twin for the length of the forward, and HRNet's exchange units run
    theirs, so nothing launches."""
    from synergynet_tpu_torch.nn.backbones import hrnet, mobilenet_v2, resnest
    from synergynet_tpu_torch.ops.hr_fuse import hr_fuse_reference
    seen = []

    def tally(x, bn, act="none", residual=None, residual_bn=None):
        form = ("none" if residual is None else
                "raw" if residual_bn is None else "bn")
        seen.append((*x.shape[1:], act, form))
        return bn_act_reference(x, bn, act, residual, residual_bn)

    saved = {m: m.bn_act for m in (mobilenet_v2, resnest, hrnet)}
    fuse = hrnet.hr_fuse
    for m in saved:
        m.bn_act = tally
    hrnet.hr_fuse = hr_fuse_reference
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for m, f in saved.items():
            m.bn_act = f
        hrnet.hr_fuse = fuse
    return seen
