"""The sparse mixture-of-experts layer's three passes: kernels M1, G1 and
M2 and their plain twins.

:func:`moe_mlp` ``(z, u, router, w1, b1, w2, b2)`` gives ``z + sum over
the top two experts e of g_e MLP_e(u)`` for T tokens (nn/moe.py's
``MoeMlp``, V-MoE's layer served dropless):

- :func:`moe_dispatch` (M1, ``csrc/moe.cu``): the router's logits ``u
  w^T`` in f32, the softmax, the top two experts and their gates (not
  renormalised), and the dispatch of every (token, k) pair to a row of an
  expert-contiguous buffer ``x`` (2T, D): expert e's rows run from
  ``offsets[e]`` to ``offsets[e + 1]``, its tokens in ascending order;
- :func:`moe_gemm` (G1, ``ops/moe_gemm_triton.py``), twice: ``h =
  GELU(x w1[e] + b1[e])`` then ``y = h w2[e] + b2[e]`` over each expert's
  rows, f32 accumulation, rounded once to bf16;
- :func:`moe_combine` (M2, ``csrc/moe.cu``): ``z + (g1 y[slot1] + g2
  y[slot2])`` in f32, rounded once.

On a CUDA tensor each launches its kernel (bf16 tokens, or it raises);
nothing reads the host and every shape follows from T alone, so a CUDA
graph captures the layer whatever the routing: M1 writes the offsets on
the device and G1's grid is the most tiles any routing needs. Where
autograd records the call on a card, the kernels run forward and the
twins, recomputed, give the gradient. On a CPU tensor the twins run:
:func:`moe_dispatch_reference` rounds every operation where M1 does, in
M1's order (module doc of ``csrc/moe.cu``), so on a card's tensors it gives
M1's bits; :func:`moe_combine_reference` gives M2's; and
:func:`moe_gemm_reference` is the per-expert product that G1 equals to
within bf16's rounding of its output (the products' order differs).

The launch table of :mod:`~synergynet_tpu_torch.ops.cuda_build` counts
M1's two launches under ``"synergy_moe_dispatch"``, M2's under
``"synergy_moe_combine"`` and G1's (a Triton launch) under
``"synergy_moe_gemm"``; in a device trace their kernels' names hold
``moe_dispatch``, ``moe_combine`` and ``moe_gemm``.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from synergynet_tpu_torch.core.paths import build_dir
from synergynet_tpu_torch.ops.cuda_build import (check_tensor, launch,
                                                 launches, require_sm90)

TOP_K = 2
BLOCK_M = 128               # G1's row tile; M1's ``tiles`` count in it
                            # (csrc/moe.cu holds the same constant)
# G1's column and depth tiles and its Triton launch options: the fastest
# of six on an H100 at both passes' shapes (PERF.md, section 6).
GEMM_TILE = dict(BN=256, BK=64)
GEMM_LAUNCH = dict(num_warps=8, num_stages=3)
SEGMENT = 256               # M1 counts per segment; a scatter block each
ROUTE_BLOCKS_PER_SM = 2     # M1's route grid; two blocks share a SM
COMBINE_BLOCKS_PER_SM = 8
_GEMM = None


class Dispatch(NamedTuple):
    """M1's outputs for T tokens over E experts."""
    expert: torch.Tensor    # (T, 2) int32: the top two experts, best first
    gate: torch.Tensor      # (T, 2) f32: their probabilities
    slot: torch.Tensor      # (T, 2) int32: the rows of x they went to
    offsets: torch.Tensor   # (E + 1,) int32: expert e's rows start here
    tiles: torch.Tensor     # (E + 1,) int32: the same in BLOCK_M row tiles
    x: torch.Tensor         # (2T, D): the tokens' rows, by expert
    stats: torch.Tensor     # (2,) int64: rows routed, the busiest's rows


# -- the twins ----------------------------------------------------------------

def router_logits_reference(u: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """(T, D) tokens, (E, D) router weight -> (T, E) f32 logits, each
    product and add rounded once in the order of D, as M1 sums."""
    uf, wf = u.float(), w.float()
    acc = torch.zeros(uf.shape[0], wf.shape[0], device=u.device)
    for k in range(uf.shape[1]):
        acc = acc + uf[:, k:k + 1] * wf[:, k]
    return acc


def router_probs_reference(logits: torch.Tensor) -> torch.Tensor:
    """The softmax over the last axis as M1 computes it: exp of the logits
    less their max, over their sum folded in halves (E a power of two)."""
    ex = torch.exp(logits - logits.max(-1, keepdim=True).values)
    s = ex
    while s.shape[-1] > 1:
        half = s.shape[-1] // 2
        s = s[..., :half] + s[..., half:]
    return ex / s


def top2_reference(probs: torch.Tensor):
    """-> (gates (T, 2) f32, experts (T, 2) int32): the two largest
    probabilities, a tie to the lower expert (a stable sort)."""
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    return (gate[:, :TOP_K].contiguous(),
            expert[:, :TOP_K].to(torch.int32).contiguous())


def moe_dispatch_reference(u: torch.Tensor, w: torch.Tensor) -> Dispatch:
    """The plain twin of :func:`moe_dispatch`."""
    t, e = u.shape[0], w.shape[0]
    _check_experts(e)
    gate, expert = top2_reference(router_probs_reference(
        router_logits_reference(u, w)))
    flat = expert.reshape(-1).long()
    order = torch.sort(flat, stable=True).indices
    slot = torch.empty_like(flat)
    slot[order] = torch.arange(2 * t, device=u.device)
    counts = torch.bincount(flat, minlength=e)
    zero = counts.new_zeros(1)
    offsets = torch.cat([zero, counts.cumsum(0)]).to(torch.int32)
    tiles = torch.cat([zero, ((counts + BLOCK_M - 1) // BLOCK_M).cumsum(0)]
                      ).to(torch.int32)
    stats = torch.stack([counts.sum(), counts.max()]).to(torch.int64)
    return Dispatch(expert, gate, slot.to(torch.int32).reshape(t, TOP_K),
                    offsets, tiles, u[order // TOP_K], stats)


def moe_gemm_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       offsets: torch.Tensor, gelu: bool) -> torch.Tensor:
    """The plain twin of :func:`moe_gemm`: expert by expert, ``act(x[rows]
    @ w[e] + b[e])`` in f32, rounded once to ``x``'s dtype."""
    out = x.new_empty(x.shape[0], w.shape[2])
    bounds = offsets.tolist()
    for e in range(w.shape[0]):
        r0, r1 = bounds[e], bounds[e + 1]
        acc = x[r0:r1].float() @ w[e].float() + b[e].float()
        out[r0:r1] = (F.gelu(acc) if gelu else acc).to(out.dtype)
    return out


def moe_combine_reference(z: torch.Tensor, y: torch.Tensor,
                          slot: torch.Tensor, gate: torch.Tensor
                          ) -> torch.Tensor:
    """The plain twin of :func:`moe_combine`."""
    s = slot.long()
    mix = gate[:, 0:1] * y[s[:, 0]].float() + gate[:, 1:2] * y[s[:, 1]].float()
    return (z.float() + mix).to(z.dtype)


# -- the kernels --------------------------------------------------------------

def _check_experts(e: int) -> None:
    if e < 4 or e > 32 or e & (e - 1):
        raise ValueError(f"{e} experts: the layer takes a power of two from "
                         f"4 to 32")


def _check_tokens(name: str, t: torch.Tensor, d=None) -> None:
    check_tensor(name, t, (torch.bfloat16,), (None, d), t.device)
    if t.shape[1] % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows of {t.shape[1]} values at "
                         f"{t.data_ptr() % 16} past 16 bytes; the kernels "
                         f"take a multiple of 8, 16-byte aligned")


def _blocks(device, per_sm: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count \
        * per_sm


def moe_dispatch(u: torch.Tensor, w: torch.Tensor) -> Dispatch:
    """(T, D) tokens, (E, D) f32 router weight -> :class:`Dispatch`: M1 on
    a card (two launches), the twin on the CPU."""
    if u.device.type == "cpu":
        return moe_dispatch_reference(u, w)
    if u.device.type != "cuda":
        raise ValueError(f"no MoE dispatch for device {u.device}")
    t, d = u.shape
    e = w.shape[0]
    _check_experts(e)
    _check_tokens("tokens", u)
    check_tensor("router weight", w, (torch.float32,), (e, d), u.device)
    if 2 * t >= 2 ** 31:
        raise ValueError(f"{t} tokens: M1 takes fewer than 2^30")
    require_sm90(u.device, "MoE dispatch")
    segments = -(-t // SEGMENT)
    per_block = -(-segments // _blocks(u.device, ROUTE_BLOCKS_PER_SM))
    blocks = -(-segments // per_block)
    i32 = dict(dtype=torch.int32, device=u.device)
    out = Dispatch(
        torch.empty((t, TOP_K), **i32),
        torch.empty((t, TOP_K), dtype=torch.float32, device=u.device),
        torch.empty((t, TOP_K), **i32), torch.empty(e + 1, **i32),
        torch.empty(e + 1, **i32), u.new_empty((TOP_K * t, d)),
        torch.empty(2, dtype=torch.int64, device=u.device))
    counts = torch.empty((e, segments), **i32)
    argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
    for phase in (0, 1):
        launch("moe", "synergy_moe_dispatch", argtypes, u.device, phase, u,
               w, out.expert, out.gate, counts, out.offsets, out.tiles,
               out.slot, out.x, out.stats, t, d, e, blocks, per_block)
    return out


def _gemm():
    global _GEMM
    if _GEMM is None:
        os.environ.setdefault("TRITON_CACHE_DIR",
                              os.path.join(build_dir(), "triton"))
        from synergynet_tpu_torch.ops import moe_gemm_triton
        _GEMM = moe_gemm_triton.moe_gemm_kernel
    return _GEMM


def moe_gemm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             offsets: torch.Tensor, tiles: torch.Tensor,
             gelu: bool) -> torch.Tensor:
    """(R, K) rows by expert, (E, K, N) weights, (E, N) biases, M1's
    ``offsets`` and ``tiles`` -> (R, N): G1 on a card, the twin on the
    CPU (``tiles`` unread there)."""
    if x.device.type == "cpu":
        return moe_gemm_reference(x, w, b, offsets, gelu)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped GEMM for device {x.device}")
    r, k = x.shape
    e, _, n = w.shape
    bn, bk = GEMM_TILE["BN"], GEMM_TILE["BK"]
    _check_tokens("rows", x)
    check_tensor("expert weights", w, (torch.bfloat16,), (e, k, n), x.device)
    check_tensor("expert biases", b, (torch.bfloat16,), (e, n), x.device)
    for name, t in (("offsets", offsets), ("tiles", tiles)):
        check_tensor(name, t, (torch.int32,), (e + 1,), x.device)
    if n % bn or k % bk:
        raise ValueError(f"expert GEMM {k} -> {n}: G1 takes multiples of "
                         f"{bk} and {bn}")
    out = x.new_empty((r, n))
    if r:
        grid = ((-(-r // BLOCK_M) + e) * (n // bn),)
        with torch.cuda.device(x.device):
            _gemm()[grid](x, w, b, out, offsets, tiles, n, k, E=e,
                          EP=max(2, 1 << (e - 1).bit_length()), GELU=gelu,
                          BM=BLOCK_M, **GEMM_TILE, **GEMM_LAUNCH)
        launches["synergy_moe_gemm"] += 1
    return out


def moe_combine(z: torch.Tensor, y: torch.Tensor, slot: torch.Tensor,
                gate: torch.Tensor) -> torch.Tensor:
    """(T, D) residual, (2T, D) expert outputs, M1's slots and gates ->
    (T, D): M2 on a card, the twin on the CPU."""
    if z.device.type == "cpu":
        return moe_combine_reference(z, y, slot, gate)
    if z.device.type != "cuda":
        raise ValueError(f"no MoE combine for device {z.device}")
    t, d = z.shape
    _check_tokens("residual", z)
    _check_tokens("expert outputs", y, d)
    check_tensor("slots", slot, (torch.int32,), (t, TOP_K), z.device)
    check_tensor("gates", gate, (torch.float32,), (t, TOP_K), z.device)
    out = torch.empty_like(z)
    vecs = t * d // 8
    blocks = max(1, min(-(-vecs // 256),
                        _blocks(z.device, COMBINE_BLOCKS_PER_SM)))
    launch("moe", "synergy_moe_combine", [ctypes.c_void_p] * 5
           + [ctypes.c_int] * 3, z.device, z, y, slot, gate, out, t, d,
           blocks)
    return out


def moe_mlp_reference(z: torch.Tensor, u: torch.Tensor,
                      router: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor):
    """The plain twin of :func:`moe_mlp`: the three twins in turn."""
    d = moe_dispatch_reference(u, router)
    h = moe_gemm_reference(d.x, w1, b1, d.offsets, gelu=True)
    y = moe_gemm_reference(h, w2, b2, d.offsets, gelu=False)
    return moe_combine_reference(z, y, d.slot, d.gate), d


def _launch(z, u, router, w1, b1, w2, b2):
    d = moe_dispatch(u, router)
    h = moe_gemm(d.x, w1, b1, d.offsets, d.tiles, gelu=True)
    y = moe_gemm(h, w2, b2, d.offsets, d.tiles, gelu=False)
    return moe_combine(z, y, d.slot, d.gate), d


class _MoeMlp(torch.autograd.Function):
    """M1, G1 twice and M2 forward; the twins' gradient, recomputed (M1's
    routing equals its twin's bit for bit, so the twins route alike)."""

    @staticmethod
    def forward(ctx, *inputs):
        ctx.save_for_backward(*inputs)
        out, d = _launch(*inputs)
        ctx.mark_non_differentiable(*d)
        return (out, *d)

    @staticmethod
    def backward(ctx, grad, *_):
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            out, _ = moe_mlp_reference(*inputs)
        wanted = [t for t, need in zip(inputs, needs) if need]
        found = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(found) if need else None for need in needs)


def moe_mlp(z: torch.Tensor, u: torch.Tensor, router: torch.Tensor,
            w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
            b2: torch.Tensor):
    """(T, D) residual and layer-normed tokens -> (z + the top-2 experts'
    weighted sum (T, D), :class:`Dispatch`): M1, G1 twice, M2 on a card,
    the twins on the CPU (module doc). Where autograd records the call on
    a card, the kernels run forward and the twins give the gradient."""
    inputs = (z, u, router, w1, b1, w2, b2)
    if z.device.type == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in inputs):
        out, *d = _MoeMlp.apply(*inputs)
        return out, Dispatch(*d)
    return _launch(*inputs)
