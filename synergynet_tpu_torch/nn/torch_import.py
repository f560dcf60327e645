"""Import reference SynergyNet PyTorch checkpoints into the flax-layout tree.

Counterpart of ``synergynet_tpu/nn/torch_import.py``. The reference ships
``pretrained/best.pth.tar``, a torch ``state_dict`` with DataParallel
``module.`` prefixes. This module maps its names onto the flax variable
tree of SynergyNet (the JAX package's layout, which the port's
:func:`~synergynet_tpu_torch.convert.synergy_state_dict` loads) for every
backbone family the reference dispatches:

torch (reference)                         flax
-----------------                         ----
I2P.backbone.features.0.{0,1}             backbone/ConvBNReLU6_0/{Conv_0,BatchNorm_0}
I2P.backbone.features.k.conv...  (1<=k<=17)  backbone/InvertedResidual_{k-1}/...
I2P.backbone.features.18.{0,1}            backbone/ConvBNReLU6_1/...
I2P.backbone.classifier_{ori,shape,exp}.1 backbone/ParamHead_0/fc_{pose,shape,exp}
I2P.backbone.conv1 / bn1 / dw*_* (v1)     backbone/_ConvBN_k/...
I2P.backbone.layer{s}.{i}.conv* (resnet)  backbone/{BasicBlock,Bottleneck}_k/...
I2P.backbone.blocks.{s}.{l} (ghostnet)    backbone/GhostBottleneck_k/...
I2P.backbone.layer{s}.{i}.conv2.* (resnest) backbone/ResNeStBottleneck_k/SplAtConv2d_0/...
forwardDirection.conv{1-5}/bn{1-5}        forward_direction/PointEncoder_0/enc{1-5}_{fc,bn}
forwardDirection.conv{6-9}/bn{6-9}        forward_direction/dec{1-4}_{fc,bn}
reverseDirection.conv{1-5}/bn{1-5}        reverse_direction/PointEncoder_0/enc{1-5}_{fc,bn}
reverseDirection.conv6_{1,2,3}/bn6_{1,2,3} reverse_direction/head_{rot,shape,exp}_{fc,bn}

Weight layouts: conv OIHW -> HWIO (depthwise (C, 1, H, W) -> (H, W, 1, C)),
Conv1d (out, in, 1) and Linear (out, in) -> Dense (in, out); BatchNorm
weight/bias -> scale/bias and running statistics -> batch_stats. The
registered 3DMM buffers (``param_mean``, ``w_shp``, ...) are dropped. The
MobileNetV2 map also serves the ``mobilenet_v2_0.5`` / ``_1.4`` widths,
whose reference layout is the same at other shapes (the JAX map takes
only ``mobilenet_v2``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from synergynet_tpu_torch.core.checkpoint import (load_torch_state_dict,
                                                  restore_checkpoint)

# MobileNetV2 schedule (t, c, n, s): 17 inverted-residual blocks.
_IR_EXPAND = [1] + [6] * 16


class _Mapping:
    """Accumulates torch-name -> flax-path entries with layout helpers."""

    def __init__(self):
        self.m: Dict[str, Tuple[str, ...]] = {}

    def conv(self, tname, fpath):
        self.m[f"{tname}.weight"] = ("params",) + fpath + ("kernel",)

    def dense(self, tname, fpath):
        """Linear, Conv1d or biased Conv2d (weight + bias)."""
        self.m[f"{tname}.weight"] = ("params",) + fpath + ("kernel",)
        self.m[f"{tname}.bias"] = ("params",) + fpath + ("bias",)

    def bn(self, tname, fpath):
        self.m[f"{tname}.weight"] = ("params",) + fpath + ("scale",)
        self.m[f"{tname}.bias"] = ("params",) + fpath + ("bias",)
        self.m[f"{tname}.running_mean"] = ("batch_stats",) + fpath + ("mean",)
        self.m[f"{tname}.running_var"] = ("batch_stats",) + fpath + ("var",)

    def heads(self, bb, names, with_texture=False):
        """Reference multi-decoder heads -> shared ParamHead_0.

        ``names``: (pose_tname, shape_tname, exp_tname, texture_tname)."""
        pairs = list(zip(names[:3], ("pose", "shape", "exp")))
        if with_texture:
            pairs.append((names[3], "texture"))
        for tname, fname in pairs:
            self.dense(f"{bb}.{tname}", ("backbone", "ParamHead_0",
                                         f"fc_{fname}"))


def _mobilenet_v2_names(p: _Mapping) -> None:
    """Reference backbone_nets/mobilenetv2_backbone.py:77-208."""
    bb = "I2P.backbone"
    # Stem (features.0 = ConvBNReLU) and final 1x1 (features.18).
    p.conv(f"{bb}.features.0.0", ("backbone", "ConvBNReLU6_0", "Conv_0"))
    p.bn(f"{bb}.features.0.1", ("backbone", "ConvBNReLU6_0", "BatchNorm_0"))
    p.conv(f"{bb}.features.18.0", ("backbone", "ConvBNReLU6_1", "Conv_0"))
    p.bn(f"{bb}.features.18.1", ("backbone", "ConvBNReLU6_1", "BatchNorm_0"))

    for k, expand in enumerate(_IR_EXPAND, start=1):
        t = f"{bb}.features.{k}.conv"
        f = ("backbone", f"InvertedResidual_{k - 1}")
        if expand == 1:
            # [ConvBNReLU(dw), conv, bn]
            p.conv(f"{t}.0.0", f + ("ConvBNReLU6_0", "Conv_0"))
            p.bn(f"{t}.0.1", f + ("ConvBNReLU6_0", "BatchNorm_0"))
            p.conv(f"{t}.1", f + ("Conv_0",))
            p.bn(f"{t}.2", f + ("BatchNorm_0",))
        else:
            # [ConvBNReLU(1x1), ConvBNReLU(dw), conv, bn]
            p.conv(f"{t}.0.0", f + ("ConvBNReLU6_0", "Conv_0"))
            p.bn(f"{t}.0.1", f + ("ConvBNReLU6_0", "BatchNorm_0"))
            p.conv(f"{t}.1.0", f + ("ConvBNReLU6_1", "Conv_0"))
            p.bn(f"{t}.1.1", f + ("ConvBNReLU6_1", "BatchNorm_0"))
            p.conv(f"{t}.2", f + ("Conv_0",))
            p.bn(f"{t}.3", f + ("BatchNorm_0",))

    # classifier_* are Sequential(Dropout, Linear): index .1 is the Linear.
    p.heads(bb, ("classifier_ori.1", "classifier_shape.1",
                 "classifier_exp.1"))


def _mobilenet_v1_names(p: _Mapping, with_texture: bool) -> None:
    """Reference backbone_nets/mobilenetv1_backbone.py:47-140: conv1/bn1
    stem + 13 DepthWiseBlocks (conv_dw/bn_dw/conv_sep/bn_sep) + fc heads."""
    bb = "I2P.backbone"
    p.conv(f"{bb}.conv1", ("backbone", "_ConvBN_0", "Conv_0"))
    p.bn(f"{bb}.bn1", ("backbone", "_ConvBN_0", "BatchNorm_0"))
    blocks = ["dw2_1", "dw2_2", "dw3_1", "dw3_2", "dw4_1", "dw4_2",
              "dw5_1", "dw5_2", "dw5_3", "dw5_4", "dw5_5", "dw5_6", "dw6"]
    for k, t in enumerate(blocks):
        dw = ("backbone", f"_ConvBN_{1 + 2 * k}")
        sep = ("backbone", f"_ConvBN_{2 + 2 * k}")
        p.conv(f"{bb}.{t}.conv_dw", dw + ("Conv_0",))
        p.bn(f"{bb}.{t}.bn_dw", dw + ("BatchNorm_0",))
        p.conv(f"{bb}.{t}.conv_sep", sep + ("Conv_0",))
        p.bn(f"{bb}.{t}.bn_sep", sep + ("BatchNorm_0",))
    p.heads(bb, ("fc_ori", "fc_shape", "fc_exp", "fc_tex"), with_texture)


def _resnet_names(p: _Mapping, layers, block: str,
                  with_texture: bool) -> None:
    """Reference backbone_nets/resnet_backbone.py:139-254: conv1/bn1 stem,
    layer{1-4}.{i} blocks with conv{1-3}/bn{1-3} + downsample.{0,1}."""
    bb = "I2P.backbone"
    p.conv(f"{bb}.conv1", ("backbone", "Conv_0"))
    p.bn(f"{bb}.bn1", ("backbone", "BatchNorm_0"))
    bname = "BasicBlock" if block == "basic" else "Bottleneck"
    expansion = 1 if block == "basic" else 4
    k, in_ch = 0, 64
    for stage, n in enumerate(layers):
        planes = 64 * (2 ** stage)
        for i in range(n):
            t = f"{bb}.layer{stage + 1}.{i}"
            f = ("backbone", f"{bname}_{k}")
            stride = 2 if (stage > 0 and i == 0) else 1
            n_convs = 2 if block == "basic" else 3
            for c in range(n_convs):
                p.conv(f"{t}.conv{c + 1}", f + (f"Conv_{c}",))
                p.bn(f"{t}.bn{c + 1}", f + (f"BatchNorm_{c}",))
            if stride != 1 or in_ch != planes * expansion:
                p.conv(f"{t}.downsample.0", f + (f"Conv_{n_convs}",))
                p.bn(f"{t}.downsample.1", f + (f"BatchNorm_{n_convs}",))
            in_ch = planes * expansion
            k += 1
    p.heads(bb, ("fc_ori", "fc_shape", "fc_exp", "fc_tex"), with_texture)


def _ghostnet_names(p: _Mapping, with_texture: bool) -> None:
    """Reference backbone_nets/ghostnet_backbone.py:165-233: conv_stem/bn1,
    blocks.{stage}.{layer} GhostBottlenecks, blocks.9.0 ConvBnAct,
    conv_head, classifier_* heads."""
    from synergynet_tpu_torch.nn.backbones.ghostnet import GHOSTNET_CFG

    bb = "I2P.backbone"
    p.conv(f"{bb}.conv_stem", ("backbone", "Conv_0"))
    p.bn(f"{bb}.bn1", ("backbone", "BatchNorm_0"))

    # Flat block index -> the reference's (stage, layer) nesting.
    stage_sizes = [1, 1, 1, 1, 1, 1, 5, 1, 4]
    st_of = []
    for si, size in enumerate(stage_sizes):
        st_of += [(si, li) for li in range(size)]

    in_ch = 16
    for b, (_k, mid, out, se, s) in enumerate(GHOSTNET_CFG):
        si, li = st_of[b]
        t = f"{bb}.blocks.{si}.{li}"
        f = ("backbone", f"GhostBottleneck_{b}")

        def ghost(tmod, gidx, f=f, t=t):
            g = f + (f"GhostModule_{gidx}",)
            p.conv(f"{t}.{tmod}.primary_conv.0", g + ("Conv_0",))
            p.bn(f"{t}.{tmod}.primary_conv.1", g + ("BatchNorm_0",))
            p.conv(f"{t}.{tmod}.cheap_operation.0", g + ("Conv_1",))
            p.bn(f"{t}.{tmod}.cheap_operation.1", g + ("BatchNorm_1",))

        ghost("ghost1", 0)
        ci = 0                                   # running Conv_/BN_ index
        if s > 1:
            p.conv(f"{t}.conv_dw", f + (f"Conv_{ci}",))
            p.bn(f"{t}.bn_dw", f + (f"BatchNorm_{ci}",))
            ci += 1
        if se > 0:
            g = f + ("SqueezeExcite_0",)
            p.dense(f"{t}.se.conv_reduce", g + ("Conv_0",))
            p.dense(f"{t}.se.conv_expand", g + ("Conv_1",))
        ghost("ghost2", 1)
        if not (in_ch == out and s == 1):        # non-identity shortcut
            p.conv(f"{t}.shortcut.0", f + (f"Conv_{ci}",))
            p.bn(f"{t}.shortcut.1", f + (f"BatchNorm_{ci}",))
            p.conv(f"{t}.shortcut.2", f + (f"Conv_{ci + 1}",))
            p.bn(f"{t}.shortcut.3", f + (f"BatchNorm_{ci + 1}",))
        in_ch = out

    # Final ConvBnAct (blocks.9.0) + 1280 conv head (biased).
    p.conv(f"{bb}.blocks.9.0.conv", ("backbone", "Conv_1"))
    p.bn(f"{bb}.blocks.9.0.bn1", ("backbone", "BatchNorm_1"))
    p.dense(f"{bb}.conv_head", ("backbone", "Conv_2"))
    p.heads(bb, ("classifier_ori", "classifier_shape", "classifier_exp",
                 "classifier_texture"), with_texture)


def _resnest_names(p: _Mapping, layers) -> None:
    """Reference backbone_nets/ResNeSt/resnet.py:185-324 + splat.py:11-98:
    deep stem conv1.{0,1,3,4,6}/bn1, layer blocks with SplAtConv2d conv2
    (conv/bn0/fc1/bn1/fc2) and avg_down downsample.{1,2}."""
    bb = "I2P.backbone"
    p.conv(f"{bb}.conv1.0", ("backbone", "Conv_0"))
    p.bn(f"{bb}.conv1.1", ("backbone", "BatchNorm_0"))
    p.conv(f"{bb}.conv1.3", ("backbone", "Conv_1"))
    p.bn(f"{bb}.conv1.4", ("backbone", "BatchNorm_1"))
    p.conv(f"{bb}.conv1.6", ("backbone", "Conv_2"))
    p.bn(f"{bb}.bn1", ("backbone", "BatchNorm_2"))

    k, in_ch = 0, 64                            # stem_width*2 = 64
    for stage, n in enumerate(layers):
        planes = 64 * (2 ** stage)
        for i in range(n):
            t = f"{bb}.layer{stage + 1}.{i}"
            f = ("backbone", f"ResNeStBottleneck_{k}")
            stride = 2 if (stage > 0 and i == 0) else 1
            p.conv(f"{t}.conv1", f + ("Conv_0",))
            p.bn(f"{t}.bn1", f + ("BatchNorm_0",))
            g = f + ("SplAtConv2d_0",)
            p.conv(f"{t}.conv2.conv", g + ("Conv_0",))
            p.bn(f"{t}.conv2.bn0", g + ("BatchNorm_0",))
            p.dense(f"{t}.conv2.fc1", g + ("Conv_1",))
            p.bn(f"{t}.conv2.bn1", g + ("BatchNorm_1",))
            p.dense(f"{t}.conv2.fc2", g + ("Conv_2",))
            p.conv(f"{t}.conv3", f + ("Conv_1",))
            p.bn(f"{t}.bn3", f + ("BatchNorm_1",))
            if stride != 1 or in_ch != planes * 4:
                # avg_down: downsample.0 is the (param-free) AvgPool2d.
                p.conv(f"{t}.downsample.1", f + ("Conv_2",))
                p.bn(f"{t}.downsample.2", f + ("BatchNorm_2",))
            in_ch = planes * 4
            k += 1
    p.heads(bb, ("fc_ori", "fc_shape", "fc_exp"))


def _synergy_mlp_names(p: _Mapping) -> None:
    """MLP_for / MLP_rev (reference backbone_nets/pointnet_backbone.py)."""
    for tmod, fmod in (("forwardDirection", "forward_direction"),
                       ("reverseDirection", "reverse_direction")):
        for i in range(1, 6):
            p.dense(f"{tmod}.conv{i}", (fmod, "PointEncoder_0", f"enc{i}_fc"))
            p.bn(f"{tmod}.bn{i}", (fmod, "PointEncoder_0", f"enc{i}_bn"))
    for i, dec in zip(range(6, 10), ("dec1", "dec2", "dec3", "dec4")):
        p.dense(f"forwardDirection.conv{i}",
                ("forward_direction", f"{dec}_fc"))
        p.bn(f"forwardDirection.bn{i}", ("forward_direction", f"{dec}_bn"))
    for suffix, head in (("1", "head_rot"), ("2", "head_shape"),
                         ("3", "head_exp")):
        p.dense(f"reverseDirection.conv6_{suffix}",
                ("reverse_direction", f"{head}_fc"))
        p.bn(f"reverseDirection.bn6_{suffix}",
             ("reverse_direction", f"{head}_bn"))


def _torch_to_flax_names(arch: str = "mobilenet_v2",
                         with_texture: bool = False
                         ) -> Dict[str, Tuple[str, ...]]:
    """Maps torch parameter name -> (collection, flax path...) for every
    backbone family the reference dispatches (model_building.py:40-51)."""
    from synergynet_tpu_torch.nn.backbones.resnest import RESNEST_LAYERS
    from synergynet_tpu_torch.nn.backbones.resnet import RESNET_LAYERS

    p = _Mapping()
    if arch == "mobilenet_v2" or arch.startswith("mobilenet_v2_"):
        _mobilenet_v2_names(p)
    elif arch.startswith("mobilenet_1"):
        _mobilenet_v1_names(p, with_texture)
    elif arch in RESNET_LAYERS:
        layers, block, _, _ = RESNET_LAYERS[arch]
        _resnet_names(p, layers, block, with_texture)
    elif arch == "ghostnet":
        _ghostnet_names(p, with_texture)
    elif arch in RESNEST_LAYERS:
        _resnest_names(p, RESNEST_LAYERS[arch][0])
    elif arch.startswith("resnest50_fast"):
        _resnest_names(p, (3, 4, 6, 3))
    else:
        raise ValueError(f"no torch-import mapping for arch '{arch}'")
    _synergy_mlp_names(p)
    return p.m


def _convert_leaf(torch_name: str, arr: np.ndarray) -> np.ndarray:
    if not torch_name.endswith(".weight"):
        return arr
    if arr.ndim == 4:                       # conv OIHW -> HWIO
        return np.transpose(arr, (2, 3, 1, 0))
    if arr.ndim == 3:                       # Conv1d (out,in,1) -> (in,out)
        return np.transpose(arr[:, :, 0], (1, 0))
    if arr.ndim == 2:                       # Linear (out,in) -> (in,out)
        if ".bn" in torch_name or "running" in torch_name:
            return arr
        return np.transpose(arr, (1, 0))
    return arr


def convert_synergynet_state_dict(sd: Dict[str, np.ndarray],
                                  strict: bool = False,
                                  arch: str = "mobilenet_v2",
                                  with_texture: bool = False) -> dict:
    """torch state_dict (numpy arrays or tensors) -> flax-layout variables
    ``{"params": ..., "batch_stats": ...}`` of numpy arrays. Unmapped torch
    keys (3DMM buffers, ``num_batches_tracked``, unused texture heads) are
    ignored; with ``strict`` a mapped-but-missing torch key raises."""
    mapping = _torch_to_flax_names(arch, with_texture)
    out: dict = {"params": {}, "batch_stats": {}}

    def put(path, leaf):
        node = out[path[0]]
        for k in path[1:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    seen = set()
    for name, val in sd.items():
        name = name.removeprefix("module.")
        if name not in mapping:
            continue
        arr = np.asarray(val.detach().cpu().numpy()
                         if hasattr(val, "detach") else val)
        put(mapping[name], _convert_leaf(name, arr))
        seen.add(name)
    if strict:
        missing = sorted(set(mapping) - seen)
        if missing:
            raise KeyError(f"checkpoint missing {len(missing)} leaves, "
                           f"first: {missing[:5]}")
    return out


def _shapes(tree: dict, prefix: Tuple[str, ...] = ()) -> Dict[str, tuple]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tuple(np.shape(v))
    return out


def _template(arch: str) -> dict:
    """The port's SynergyNet(arch) as a flax-layout tree (float32 zeros of
    the init's shapes)."""
    from synergynet_tpu_torch.convert import flax_from_state_dict
    from synergynet_tpu_torch.nn.synergy import SynergyNet
    with torch.device("meta"):
        model = SynergyNet(arch=arch)
    return flax_from_state_dict({k: torch.zeros(v.shape) for k, v in
                                 model.state_dict().items()})


def load_synergynet_variables(path: str, arch: str = "mobilenet_v2",
                              validate_against: Optional[dict] = None
                              ) -> dict:
    """A checkpoint -> flax-layout variables of numpy arrays: a framework
    ``.npz`` (either package's, restored in the structure of
    ``validate_against`` or of SynergyNet(arch)) or a reference
    ``.pth.tar`` (:func:`~synergynet_tpu_torch.core.checkpoint.
    load_torch_state_dict`: ``torch.load`` with ``weights_only=False`` as
    the JAX package reads it, so the file is unpickled whole and must come
    from a trusted source), converted strictly for ``arch``. With
    ``validate_against``, a reference tree whose leaf paths or shapes
    differ raises."""
    if path.endswith(".npz"):
        return restore_checkpoint(path, validate_against or _template(arch))
    variables = convert_synergynet_state_dict(load_torch_state_dict(path),
                                              strict=True, arch=arch)
    if validate_against is not None:
        want, got = _shapes(validate_against), _shapes(variables)
        if want != got:
            only_w = set(want) - set(got)
            only_g = set(got) - set(want)
            raise ValueError(f"tree mismatch: missing={sorted(only_w)[:4]} "
                             f"extra={sorted(only_g)[:4]}")
    return variables


def expected_torch_shapes(arch: str = "mobilenet_v2") -> Dict[str, tuple]:
    """The reference checkpoint's shape for every mapped leaf, from the
    port's SynergyNet(arch): what a ``best.pth.tar`` of ``arch`` holds, so
    a complete reference-layout state dict can be made without the file."""
    from synergynet_tpu_torch.nn.synergy import SynergyNet
    with torch.device("meta"):
        state = SynergyNet(arch=arch).state_dict()
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}
    out = {}
    for tname, fpath in _torch_to_flax_names(arch).items():
        shape = tuple(state[".".join(fpath[1:-1] + (leaf[fpath[-1]],))]
                      .shape)
        if tname.endswith(".weight") and len(shape) == 2 and \
                "conv" in tname.split(".")[-2]:
            shape += (1,)                   # Conv1d
        out[tname] = shape
    return out


def seeded_torch_state_dict(shapes: Dict[str, tuple], seed: int
                            ) -> Dict[str, torch.Tensor]:
    """A complete state dict of the given names and shapes, drawn from
    ``numpy.random.default_rng(seed)`` at a trained net's scales, for tests
    and smoke runs without the released weights: conv, Conv1d and Linear
    weights normal with variance 1 / fan_in, BatchNorm scales and running
    variances uniform in [0.8, 1.2], biases and running means normal with
    deviation 0.05, ``num_batches_tracked`` 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=torch.int64)
            continue
        if name.endswith(".weight") and len(shape) > 1:
            a = rng.normal(0, np.sqrt(1.0 / np.prod(shape[1:])), shape)
        elif name.endswith((".weight", "running_var")):
            a = rng.uniform(0.8, 1.2, shape)
        else:
            a = rng.normal(0, 0.05, shape)
        out[name] = torch.tensor(a, dtype=torch.float32)
    return out
