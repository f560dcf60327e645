"""HRNetV2 backbone (Wang et al., TPAMI 2020, arXiv:1908.07919) in its
facial-landmark form, with the 3DMM head.

No counterpart in the JAX package: the port alone serves it. The net keeps
four streams at four resolutions alive together and exchanges them after
every module:

- stem: two 3x3 stride-2 convs of width 64 (256 -> 64 x 64 at the
  published crop), each with BatchNorm and ReLU;
- layer1: four :class:`Bottleneck` blocks, 64 -> 256 channels, the first
  with a projected shortcut;
- transitions: a 3x3 conv to 18 channels at 64 x 64, and each new branch
  (36, 72, 144 channels) from the last branch by a 3x3 stride-2 conv
  (BatchNorm + ReLU after each);
- stages 2, 3 and 4: 1, 4 and 3 :class:`HighResolutionModule`\\ s over 2,
  3 and 4 branches, each branch 4 :class:`BasicBlock`\\ s, each
  module ending in an exchange unit: output i is ``relu(sum_j f_ij(x_j))``
  with ``f_ii`` the identity, for j > i a 1x1 conv, BatchNorm and nearest
  upsample by 2^(j - i), for j < i (i - j) 3x3 stride-2 convs, each but the
  last keeping branch j's width under BatchNorm + ReLU, the last going to
  branch i's width under BatchNorm alone;
- the HRNetV2 head: branches 2-4 upsampled bilinearly (align_corners
  False) to branch 1's extent, concatenated (270 channels at W18), a 1x1
  conv with bias, BatchNorm and ReLU.

One departure from the paper: SynergyNet's 12/40/10 ``ParamHead_0`` reads
the global mean of the head's channels in place of the heatmap conv;
``forward`` returns ``(param62, pooled_feature)``.

Submodules carry flax auto-names in creation order (``Conv_k``,
``BatchNorm_k``, ``Bottleneck_k``, ``HighResolutionModule_k``,
``BasicBlock_k``, ``ParamHead_0``), so :mod:`synergynet_tpu_torch.convert`
maps a flax tree by path. Every BatchNorm of the trunk goes through
:func:`~synergynet_tpu_torch.ops.bn_act.bn_act` with its ReLU and shortcut
(kernel BN1 in eval mode on a card), and every exchange output through
:func:`~synergynet_tpu_torch.ops.hr_fuse.hr_fuse` (kernel F1). Channels-last
throughout; the crop side must be a multiple of 32.

To serve, :meth:`HRNet.pad_channels_` stores every width rounded up to
``ALIGN`` channels (18 -> 24, 36 -> 40, the head's 270 -> 272 over a
280-channel concatenation), the pad channels' weights zero, so each
activation reaches cuDNN's NHWC tensor-core convolutions aligned and is
not copied into a padded buffer first; the pad channels stay exactly 0
and the pooled feature keeps its 270 channels. Every other reader of the
parameters (conversion, training, ``load_state_dict``) sees the published
widths.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from synergynet_tpu_torch.nn.batchnorm import BatchNorm
from synergynet_tpu_torch.nn.heads import ParamHead
from synergynet_tpu_torch.nn.layers import Conv2d, spatial_mean, to_nchw
from synergynet_tpu_torch.ops.bn_act import bn_act
from synergynet_tpu_torch.ops.hr_fuse import hr_fuse

WIDTHS = (18, 36, 72, 144)      # W18's branches
# Channels a served activation is stored in multiples of: a 16-byte NHWC
# row of bf16, what cuDNN's tensor-core convolutions take unpadded.
ALIGN = 8
BLOCKS = 4                      # BasicBlocks a branch of a module
STEM = 64
LAYER1 = 4                      # Bottlenecks, 64 -> 256


class BasicBlock(nn.Module):
    """conv-BN-ReLU, conv-BN, + identity, ReLU at ``c`` channels."""

    def __init__(self, c: int):
        super().__init__()
        self.Conv_0 = Conv2d(c, c, 3, 1, 1)
        self.BatchNorm_0 = BatchNorm(c)
        self.Conv_1 = Conv2d(c, c, 3, 1, 1)
        self.BatchNorm_1 = BatchNorm(c)

    def forward(self, x):
        y = bn_act(self.Conv_0(x), self.BatchNorm_0, "relu")
        return bn_act(self.Conv_1(y), self.BatchNorm_1, "relu", x)


class Bottleneck(nn.Module):
    """1x1, 3x3, 1x1 to ``4 planes`` channels, + the shortcut (a 1x1 conv and
    BatchNorm where the width changes), ReLU."""

    def __init__(self, cin: int, planes: int):
        super().__init__()
        out = 4 * planes
        self.Conv_0 = Conv2d(cin, planes, 1)
        self.BatchNorm_0 = BatchNorm(planes)
        self.Conv_1 = Conv2d(planes, planes, 3, 1, 1)
        self.BatchNorm_1 = BatchNorm(planes)
        self.Conv_2 = Conv2d(planes, out, 1)
        self.BatchNorm_2 = BatchNorm(out)
        self.project = cin != out
        if self.project:
            self.Conv_3 = Conv2d(cin, out, 1)
            self.BatchNorm_3 = BatchNorm(out)

    def forward(self, x):
        y = bn_act(self.Conv_0(x), self.BatchNorm_0, "relu")
        y = bn_act(self.Conv_1(y), self.BatchNorm_1, "relu")
        if self.project:
            return bn_act(self.Conv_2(y), self.BatchNorm_2, "relu",
                          self.Conv_3(x), self.BatchNorm_3)
        return bn_act(self.Conv_2(y), self.BatchNorm_2, "relu", x)


def stored(c: int) -> int:
    """A published width as the served net stores it (module doc)."""
    return -(-c // ALIGN) * ALIGN


def _pad_(t: torch.Tensor, shape, at=None, fill=0.0) -> torch.Tensor:
    """``t`` placed in a tensor of ``shape`` filled with ``fill``: at the
    start of every axis, or, along axis 1, at ``at`` (pairs of source and
    destination slices)."""
    out = torch.full(shape, fill, dtype=t.dtype, device=t.device)
    if at is None:
        out[tuple(slice(0, n) for n in t.shape)] = t
    else:
        for src, dst in at:
            out[:t.shape[0], dst] = t[:, src]
    return out


def _pad_conv_(conv: nn.Conv2d, cin: int, cout: int, at=None) -> None:
    if at is None and (cin, cout) == (conv.in_channels, conv.out_channels):
        return
    w = conv.weight
    conv.weight = nn.Parameter(_pad_(w, (cout, cin) + w.shape[2:], at),
                               w.requires_grad)
    if conv.bias is not None:
        conv.bias = nn.Parameter(_pad_(conv.bias, (cout,)),
                                 conv.bias.requires_grad)
    conv.in_channels, conv.out_channels = cin, cout


def _pad_bn_(bn: BatchNorm, c: int) -> None:
    """Pad channels of weight 0, bias 0, mean 0 and variance 1: they give 0
    on a 0 input."""
    if bn.weight.shape[0] == c:
        return
    bn.weight = nn.Parameter(_pad_(bn.weight, (c,)), bn.weight.requires_grad)
    bn.bias = nn.Parameter(_pad_(bn.bias, (c,)), bn.bias.requires_grad)
    bn.running_mean = _pad_(bn.running_mean, (c,))
    bn.running_var = _pad_(bn.running_var, (c,), fill=1.0)


def exchange_paths(n: int):
    """The exchange unit's convolutions of ``n`` branches in creation order:
    for each output i and input j != i, (i, j, [(cin branch, cout branch,
    kernel, stride, relu) per conv])."""
    out = []
    for i in range(n):
        for j in range(n):
            if j > i:
                out.append((i, j, [(j, i, 1, 1, False)]))
            elif j < i:
                out.append((i, j, [(j, j if k < i - j - 1 else i, 3, 2,
                                    k < i - j - 1) for k in range(i - j)]))
    return out


class HighResolutionModule(nn.Module):
    """``BLOCKS`` BasicBlocks on each of the branches of ``widths``, then
    the exchange unit (module doc)."""

    def __init__(self, widths: Sequence[int]):
        super().__init__()
        self.n = len(widths)
        for k in range(self.n * BLOCKS):
            self.add_module(f"BasicBlock_{k}", BasicBlock(widths[k // BLOCKS]))
        self.paths = []
        k = 0
        for i, j, convs in exchange_paths(self.n):
            steps = []
            for cin, cout, kernel, stride, relu in convs:
                self.add_module(f"Conv_{k}", Conv2d(
                    widths[cin], widths[cout], kernel, stride,
                    (kernel - 1) // 2))
                self.add_module(f"BatchNorm_{k}", BatchNorm(widths[cout]))
                steps.append((k, relu))
                k += 1
            self.paths.append((i, j, steps))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = list(xs)
        for b in range(self.n):
            for m in range(BLOCKS):
                xs[b] = getattr(self, f"BasicBlock_{b * BLOCKS + m}")(xs[b])
        terms: List[list] = [[] for _ in range(self.n)]
        for i, j, steps in self.paths:
            y = xs[j]
            for k, relu in steps[:-1]:
                y = bn_act(getattr(self, f"Conv_{k}")(y),
                           getattr(self, f"BatchNorm_{k}"), "relu")
            k = steps[-1][0]
            terms[i].append((getattr(self, f"Conv_{k}")(y),
                             getattr(self, f"BatchNorm_{k}"),
                             2 ** (j - i) if j > i else 1))
        return [hr_fuse(xs[i], terms[i]) for i in range(self.n)]


class HRNet(nn.Module):
    """NHWC (B, S, S, 3) normalized images, S a multiple of 32 ->
    ``(param62 (B, 62) fp32, pooled feature (B, 270) fp32)``. ``modules``
    are the modules of stages 2, 3 and 4 (fewer for tests)."""

    kernels = ("bn_act", "hr_fuse")     # the csrc libraries BN1 and F1 launch
    input_size = 256        # the API's crop: the published landmark input

    def __init__(self, modules: Sequence[int] = (1, 4, 3),
                 dropout: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        widths = self.widths = WIDTHS
        self.padded = False
        self.Conv_0 = Conv2d(3, STEM, 3, 2, 1)
        self.BatchNorm_0 = BatchNorm(STEM)
        self.Conv_1 = Conv2d(STEM, STEM, 3, 2, 1)
        self.BatchNorm_1 = BatchNorm(STEM)
        cin = STEM
        for k in range(LAYER1):
            self.add_module(f"Bottleneck_{k}", Bottleneck(cin, 64))
            cin = 256
        conv = 2
        # the first transition: branch 0 from layer1 at its extent, branch 1
        # from layer1 at stride 2
        self._transitions = {}
        for b, stride in ((0, 1), (1, 2)):
            self.add_module(f"Conv_{conv}", Conv2d(cin, widths[b], 3, stride,
                                                   1))
            self.add_module(f"BatchNorm_{conv}", BatchNorm(widths[b]))
            self._transitions[b] = conv
            conv += 1
        self._stages = []
        k = 0
        for stage, n in enumerate(modules):
            branches = stage + 2
            if branches > 2:            # a new branch from the last one
                self.add_module(f"Conv_{conv}", Conv2d(
                    widths[branches - 2], widths[branches - 1], 3, 2, 1))
                self.add_module(f"BatchNorm_{conv}",
                                BatchNorm(widths[branches - 1]))
                self._transitions[branches - 1] = conv
                conv += 1
            names = []
            for _ in range(n):
                self.add_module(f"HighResolutionModule_{k}",
                                HighResolutionModule(widths[:branches]))
                names.append(f"HighResolutionModule_{k}")
                k += 1
            self._stages.append((branches, names))
        head = sum(widths)
        self._head = conv
        self.add_module(f"Conv_{conv}", Conv2d(head, head, 1, bias=True))
        self.add_module(f"BatchNorm_{conv}", BatchNorm(head))
        self.ParamHead_0 = ParamHead(head, dropout=dropout)

    @torch.no_grad()
    def pad_channels_(self) -> "HRNet":
        """Store every conv's and BatchNorm's channels rounded up to
        ``ALIGN`` for serving, in place and once (module doc): conv weights
        and biases zero-padded in their output and input channels (the
        stem's 3 image channels as they are), BatchNorms padded by
        :func:`_pad_bn_`, the head conv's input channels moved to the
        padded concatenation's offsets."""
        if self.padded:
            return self
        head = getattr(self, f"Conv_{self._head}")
        for m in self.modules():
            if isinstance(m, BatchNorm):
                _pad_bn_(m, stored(m.weight.shape[0]))
            elif isinstance(m, nn.Conv2d) and m is not head:
                cin = m.in_channels
                _pad_conv_(m, cin if m is self.Conv_0 else stored(cin),
                           stored(m.out_channels))
        at, src, dst = [], 0, 0
        for c in self.widths:
            at.append((slice(src, src + c), slice(dst, dst + c)))
            src, dst = src + c, dst + stored(c)
        _pad_conv_(head, dst, stored(head.out_channels), at)
        self.padded = True
        return self

    def _transition(self, b: int, x):
        k = self._transitions[b]
        return bn_act(getattr(self, f"Conv_{k}")(x),
                      getattr(self, f"BatchNorm_{k}"), "relu")

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = to_nchw(x, self.dtype)
        for i in range(2):
            x = bn_act(getattr(self, f"Conv_{i}")(x),
                       getattr(self, f"BatchNorm_{i}"), "relu")
        for k in range(LAYER1):
            x = getattr(self, f"Bottleneck_{k}")(x)
        xs = [self._transition(0, x), self._transition(1, x)]
        for branches, names in self._stages:
            if len(xs) < branches:
                xs.append(self._transition(branches - 1, xs[-1]))
            for name in names:
                xs = getattr(self, name)(xs)
        size = xs[0].shape[2:]
        y = torch.cat([xs[0]] + [
            F.interpolate(t, size=size, mode="bilinear", align_corners=False)
            for t in xs[1:]], dim=1).contiguous(
                memory_format=torch.channels_last)
        y = bn_act(getattr(self, f"Conv_{self._head}")(y),
                   getattr(self, f"BatchNorm_{self._head}"), "relu")
        feat = spatial_mean(y)[:, :sum(self.widths)].float()
        return self.ParamHead_0(feat, generator), feat
