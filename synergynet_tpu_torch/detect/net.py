"""FaceBoxes detection CNN: the folded stem_r=8 serving form and the
topologies that reference weights feed.

Counterpart of ``synergynet_tpu/detect/net.py``'s ``FaceBoxesNet``:

- ``stem_s2d=True, stem_r=8`` (folded only, what serving runs):
  ``conv1_s2d8`` (:class:`StemS2D8`), the 7x7/4 CRelu stem as a 2x2 conv
  over the space-to-depth(8) input with 4x phase-packed outputs, then the
  3x3/2 max-pool as shifted maxes over the phases
  (:func:`phase_maxpool_s2d8`); with ``stem_mode="pallas"`` the fused
  kernel of :mod:`synergynet_tpu_torch.detect.stem_fused` instead;
- ``stem_s2d=True, stem_r=4``: ``conv1`` a 2x2 CRelu over the
  space-to-depth(4) input, padded ((1, 0), (1, 0));
- ``stem_s2d=False``: ``conv1`` the reference's 3-channel 7x7/4 CRelu;
- then, in all three, a 3x3/2 max-pool (the stem_r=8 stem has it inside),
  the 5x5/2 CRelu ``conv2`` and a 3x3/2 max-pool, three Inception blocks,
  ``conv3_*`` and ``conv4_*``, and the loc/conf heads on three sources.

``folded=True`` is the inference form with BatchNorm folded into the
convs (:func:`fold_bn_variables`): a CRelu is one channel-doubled conv +
ReLU, a ``BasicConv2d`` a conv with bias + ReLU. ``folded=False`` keeps
the reference's ``conv`` + ``bn`` (+ ``cat[x, -x]`` in a CRelu) + ReLU.
Public tensors stay NHWC as in the JAX package; inside, activations are
NCHW in ``channels_last`` memory. The numpy helpers at the end convert
weight trees exactly as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from synergynet_tpu_torch.nn.batchnorm import BatchNorm

NUM_CLASSES = 2
ANCHORS_PER_CELL = (21, 1, 1)
STEM_MODES = (None, "xla", "pallas")


class ConvUnit(nn.Module):
    """``BasicConv2d`` (conv + BN + ReLU) or, with ``crelu``, ``CRelu``
    (conv + BN + ``cat[x, -x]`` + ReLU) under the flax names: ``conv`` and,
    unfolded, ``bn``. Folded, the conv has a bias, BN is inside it, and a
    CRelu's conv has ``2 * cout`` channels (``[a*K, -a*K]``), so the unit is
    conv + ReLU. ``pad`` is an int (both sides) or F.pad's (left, right,
    top, bottom)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 pad=0, folded: bool = True, crelu: bool = False):
        super().__init__()
        self.pad = pad if isinstance(pad, tuple) else None
        self.crelu = crelu and not folded
        conv_out = 2 * cout if crelu and folded else cout
        self.conv = nn.Conv2d(cin, conv_out, kernel, stride,
                              0 if self.pad else pad, bias=folded)
        if not folded:
            self.bn = BatchNorm(cout)

    def forward(self, x):
        if self.pad:
            x = F.pad(x, self.pad)
        x = self.conv(x)
        if hasattr(self, "bn"):
            x = self.bn(x)
        if self.crelu:
            x = torch.cat([x, -x], dim=1)
        return F.relu(x)


class Inception(nn.Module):
    """4-branch Inception block, 128 -> 128 channels."""

    def __init__(self, folded: bool = True):
        super().__init__()
        unit = lambda cin, cout, k: ConvUnit(    # noqa: E731
            cin, cout, k, pad=k // 2, folded=folded)
        self.branch1x1 = unit(128, 32, 1)
        self.branch1x1_2 = unit(128, 32, 1)
        self.branch3x3_reduce = unit(128, 24, 1)
        self.branch3x3 = unit(24, 32, 3)
        self.branch3x3_reduce_2 = unit(128, 24, 1)
        self.branch3x3_2 = unit(24, 32, 3)
        self.branch3x3_3 = unit(32, 32, 3)

    def forward(self, x):
        b0 = self.branch1x1(x)
        # count_include_pad=True: the reference divides by the full window
        # at padded borders.
        pool = F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)
        b1 = self.branch1x1_2(pool)
        b2 = self.branch3x3(self.branch3x3_reduce(x))
        b3 = self.branch3x3_3(self.branch3x3_2(self.branch3x3_reduce_2(x)))
        return torch.cat([b0, b1, b2, b3], dim=1)


def phase_maxpool_s2d8(y: torch.Tensor, cout: int) -> torch.Tensor:
    """3x3 stride-2 pad-1 max-pool over the stride-4 grid, on phase-packed
    conv outputs ``y`` (B, 4*cout, H/8, W/8): channel block (2p+q)*cout holds
    the stride-4 output at (2i+p, 2j+q). Pool output (i, j) covers rows
    {(i-1, p=1), (i, p=0), (i, p=1)} and likewise for columns. The zero pad
    is exact because the inputs are post-ReLU (>= 0)."""
    y00, y01, y10, y11 = (y[:, i * cout:(i + 1) * cout] for i in range(4))

    def up(a):      # block i-1's value at position i (row -1 -> 0 pad)
        return F.pad(a, (0, 0, 1, 0))[:, :, :-1]

    def left(a):
        return F.pad(a, (1, 0, 0, 0))[:, :, :, :-1]

    r0 = torch.maximum(torch.maximum(up(y10), y00), y10)    # col phase q=0
    r1 = torch.maximum(torch.maximum(up(y11), y01), y11)    # col phase q=1
    return torch.maximum(torch.maximum(left(r1), r0), r1)


class StemS2D8(nn.Module):
    """conv1 + max-pool of the deep-s2d stem: 2x2 conv 192 -> 4*cout with
    padding ((1, 0), (1, 0)), bias, ReLU, then :func:`phase_maxpool_s2d8`.

    ``mode`` None or "xla" runs that as a cuDNN conv and shifted maxes, the
    JAX package's XLA stem. "pallas" keeps the JAX package's name for its
    Pallas stem (``detect/stem_pallas.py::_stem_kernel``) and runs the
    hand-written fused kernel of
    :func:`~synergynet_tpu_torch.detect.stem_fused.fused_stem1_s2d8` (its
    plain twin on a CPU tensor), on tap weights re-laid out once per
    weight version.
    """

    def __init__(self, cin: int = 192, cout: int = 48):
        super().__init__()
        self.cout = cout
        self.weight = nn.Parameter(torch.zeros(4 * cout, cin, 2, 2))
        self.bias = nn.Parameter(torch.zeros(4 * cout))
        self._taps = (None, None)

    def tap_weights(self) -> torch.Tensor:
        """The (4, cin, 4*cout) tap layout of ``weight``, cached until the
        weight changes (in place, or by a move to another device)."""
        from synergynet_tpu_torch.detect.stem_fused import taps_from_oihw
        key = (self.weight.device, self.weight.data_ptr(),
               self.weight._version, self.weight.dtype)
        if self._taps[0] != key:
            with torch.no_grad():
                self._taps = (key, taps_from_oihw(self.weight.detach()))
        return self._taps[1]

    def forward(self, x, mode: Optional[str] = None):
        if mode == "pallas":
            from synergynet_tpu_torch.detect.stem_fused import \
                fused_stem1_s2d8
            y = fused_stem1_s2d8(x.permute(0, 2, 3, 1).contiguous(),
                                 self.tap_weights(), self.bias.detach(),
                                 self.cout)
            return y.permute(0, 3, 1, 2)
        y = F.conv2d(F.pad(x, (1, 0, 1, 0)), self.weight, self.bias)
        return phase_maxpool_s2d8(F.relu(y), self.cout)


def check_stem_mode(stem_mode: Optional[str]) -> None:
    if stem_mode not in STEM_MODES:
        raise ValueError(f"unknown stem_mode {stem_mode!r}; "
                         f"expected one of {STEM_MODES}")


class FaceBoxesNet(nn.Module):
    """(B, H/r, W/r, 3r^2) mean-subtracted BGR packed space-to-depth(r)
    (r = 8 or 4 with ``stem_s2d``; the plain (B, H, W, 3) frame without),
    NHWC -> (loc (B, A, 4), conf (B, A, 2)) fp32 raw logits, with anchors
    in :func:`synergynet_tpu_torch.detect.anchors.generate_anchors` order.
    ``stem_mode`` applies to the stem_r=8 stem."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 stem_mode: Optional[str] = None, stem_s2d: bool = True,
                 folded: bool = True, stem_r: int = 8):
        super().__init__()
        check_stem_mode(stem_mode)
        self.dtype = dtype
        self.stem_mode = stem_mode
        self.s2d8 = stem_s2d and stem_r == 8
        if self.s2d8:
            if not folded:
                raise ValueError("stem_r=8 requires the folded (inference) "
                                 "topology")
            self.conv1_s2d8 = StemS2D8()
        elif stem_s2d:
            self.conv1 = ConvUnit(48, 24, 2, 1, (1, 0, 1, 0), folded, True)
        else:
            self.conv1 = ConvUnit(3, 24, 7, 4, 3, folded, True)
        self.conv2 = ConvUnit(48, 64, 5, 2, 2, folded, True)
        self.inception1 = Inception(folded)
        self.inception2 = Inception(folded)
        self.inception3 = Inception(folded)
        self.conv3_1 = ConvUnit(128, 128, 1, folded=folded)
        self.conv3_2 = ConvUnit(128, 256, 3, 2, 1, folded)
        self.conv4_1 = ConvUnit(256, 128, 1, folded=folded)
        self.conv4_2 = ConvUnit(128, 256, 3, 2, 1, folded)
        for i, (cin, n) in enumerate(zip((128, 256, 256), ANCHORS_PER_CELL)):
            self.add_module(f"loc{i}", nn.Conv2d(cin, n * 4, 3, padding=1))
            self.add_module(f"conf{i}", nn.Conv2d(cin, n * NUM_CLASSES, 3,
                                                  padding=1))
        self.to(dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        if self.s2d8:
            x = self.conv1_s2d8(x, self.stem_mode)
        else:
            x = F.max_pool2d(self.conv1(x), 3, stride=2, padding=1)
        x = F.max_pool2d(self.conv2(x), 3, stride=2, padding=1)
        x = self.inception3(self.inception2(self.inception1(x)))
        src1 = x                                             # stride 32
        x = self.conv3_2(self.conv3_1(x))
        src2 = x                                             # stride 64
        src3 = self.conv4_2(self.conv4_1(x))                 # stride 128
        locs, confs = [], []
        for i, src in enumerate((src1, src2, src3)):
            b = src.shape[0]
            # (B, A*4, H, W) -> NHWC -> (B, H*W*A, 4): the (row, col, anchor)
            # flattening of the JAX package's NHWC heads.
            locs.append(getattr(self, f"loc{i}")(src).permute(0, 2, 3, 1)
                        .reshape(b, -1, 4))
            confs.append(getattr(self, f"conf{i}")(src).permute(0, 2, 3, 1)
                         .reshape(b, -1, NUM_CLASSES))
        return (torch.cat(locs, dim=1).float(),
                torch.cat(confs, dim=1).float())


def space_to_depth(x: torch.Tensor, r: int = 8) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/r, W/r, r*r*C); channel (dy*r + dx)*C + c."""
    *lead, h, w, c = x.shape
    n = len(lead)
    y = x.reshape(*lead, h // r, r, w // r, r, c)
    y = y.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return y.reshape(*lead, h // r, w // r, r * r * c)


def stem_kernel_to_s2d8(kernel7) -> np.ndarray:
    """Exact re-layout of the 7x7/4 stem kernel (7, 7, Cin, Cout) HWIO into
    the deep-s2d phase kernel (2, 2, 64*Cin, 4*Cout): output phase (p, q)
    of an 8x8 block is the stride-4 conv output at (2i+p, 2j+q), its tap
    row 4p + ty - 3 lands in block i-1 (conv tap 0) when negative, else in
    block i (tap 1)."""
    k7 = np.asarray(kernel7)
    cin, cout = k7.shape[2], k7.shape[3]
    k2 = np.zeros((2, 2, 64 * cin, 4 * cout), k7.dtype)
    for p in range(2):
        for q in range(2):
            for ty in range(7):
                for tx in range(7):
                    gy, gx = 4 * p + ty - 3, 4 * q + tx - 3
                    a, dy8 = (1, gy) if gy >= 0 else (0, gy + 8)
                    b, dx8 = (1, gx) if gx >= 0 else (0, gx + 8)
                    ch = (dy8 * 8 + dx8) * cin
                    oc = (2 * p + q) * cout
                    k2[a, b, ch:ch + cin, oc:oc + cout] = k7[ty, tx]
    return k2


def stem_kernel_to_s2d(kernel7) -> np.ndarray:
    """Exact re-layout of the 7x7/4 stem kernel (7, 7, 3, 24) HWIO into the
    space-to-depth(4) 2x2 kernel (2, 2, 48, 24): tap (ty, tx) lands in block
    (by, bx) at offset (dy, dx) with ty = 4*by + dy - 1 (the -1 absorbs the
    original padding of 3 against the ((1, 0), (1, 0)) block padding);
    taps at -1 are zero."""
    k7 = np.asarray(kernel7)
    cin, cout = k7.shape[2], k7.shape[3]
    k2 = np.zeros((2, 2, 16 * cin, cout), k7.dtype)
    for by in range(2):
        for bx in range(2):
            for dy in range(4):
                for dx in range(4):
                    ty, tx = 4 * by + dy - 1, 4 * bx + dx - 1
                    if 0 <= ty < k7.shape[0] and 0 <= tx < k7.shape[1]:
                        ch = (dy * 4 + dx) * cin
                        k2[by, bx, ch:ch + cin] = k7[ty, tx]
    return k2


def variables_to_s2d(variables: dict) -> dict:
    """A FaceBoxesNet tree with the 7x7 conv1 -> the stem_r=4 tree: only
    conv1's kernel changes (a folded bias rides along)."""
    params = dict(variables["params"])
    conv = dict(params["conv1"]["conv"])
    conv["kernel"] = stem_kernel_to_s2d(conv["kernel"])
    params["conv1"] = dict(params["conv1"], conv=conv)
    return dict(variables, params=params)


def fold_to_s2d8(folded_variables: dict) -> dict:
    """A BN-folded tree with the 7x7 conv1 -> the stem_r=8 tree: conv1
    becomes ``conv1_s2d8`` with the phase-packed kernel (2, 2, 192, 192) and
    the bias tiled over the four phases."""
    params = dict(folded_variables["params"])
    c1 = params.pop("conv1")["conv"]
    k7, bias = np.asarray(c1["kernel"]), np.asarray(c1["bias"])
    if k7.shape[0] != 7:
        raise ValueError("fold_to_s2d8 expects the 7x7 stem kernel "
                         f"(got {k7.shape})")
    params["conv1_s2d8"] = {"kernel": stem_kernel_to_s2d8(k7),
                            "bias": np.tile(bias, 4)}
    return {"params": params}


def fold_bn_variables(variables: dict, eps: float = 1e-5) -> dict:
    """Fold every BatchNorm into its conv: ``a = scale / sqrt(var + eps)``,
    ``b = bias - a * mean``, ``K' = K * a``, ``bias' = b``; the two CRelu
    stems (conv1, conv2) double out to ``[a*K, -a*K]`` / ``[b, -b]``.
    Computed in float64, stored float32, as the JAX package does. Returns a
    params-only tree."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    crelu_modules = ("conv1", "conv2")

    def fold_one(p, s, crelu):
        k = np.asarray(p["conv"]["kernel"], np.float64)
        a = np.asarray(p["bn"]["scale"], np.float64) / np.sqrt(
            np.asarray(s["bn"]["var"], np.float64) + eps)
        b = np.asarray(p["bn"]["bias"], np.float64) - a * np.asarray(
            s["bn"]["mean"], np.float64)
        k2, b2 = k * a, b
        if crelu:
            k2 = np.concatenate([k2, -k2], axis=-1)
            b2 = np.concatenate([b2, -b2])
        return {"conv": {"kernel": k2.astype(np.float32),
                         "bias": b2.astype(np.float32)}}

    def walk(p, s, name=None):
        if "conv" in p and "bn" in p:
            return fold_one(p, s, crelu=name in crelu_modules)
        if "kernel" in p:              # head conv (loc*/conf*): no BN
            return p
        return {k: walk(p[k], s.get(k, {}), k) for k in p}

    return {"params": walk(params, stats)}
