"""Every backbone family of the port against the JAX package's: the
registry, each registered name's variable shapes, the forward at 120x120
on the same numpy-seeded weights in f32 and bf16, and the pools of
ResNeSt at the odd sizes 120x120 reaches.

Weights are drawn with numpy into the shapes of the JAX init (found with
``jax.eval_shape``, so no deep net is compiled for its init) at a trained
net's scales (``seeded_tree``): lecun-normal kernels, BatchNorm scales and
variances near 1, small biases and means, so activations stay O(1)
through 50 layers and every block contributes. Tolerances are
``tests/test_torch_nn.py``'s: f32 atol 1e-4, bf16 ``BF16_ATOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from synergynet_tpu.nn import SynergyNet as JaxSynergyNet
from synergynet_tpu.nn.backbones import available_backbones as jax_names
from synergynet_tpu.nn.backbones import make_backbone as jax_backbone
from synergynet_tpu_torch.convert import flax_from_state_dict, \
    state_dict_from_flax
from synergynet_tpu_torch.nn import SynergyNet, available_backbones
from synergynet_tpu_torch.nn.backbones import make_backbone
from synergynet_tpu_torch.nn.layers import cast_layers_

torch.set_num_threads(2)

BF16_ATOL = 0.08        # tests/test_torch_nn.py
FP32_ATOL = 1e-4


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tuple(v.shape)
    return out


def seeded_tree(shapes: dict, rng) -> dict:
    """numpy float32 leaves in the structure of ``shapes`` (a tree of
    ShapeDtypeStructs): conv kernels (HWIO) and dense kernels normal with
    variance 1 / fan_in, BatchNorm scales and variances uniform in
    [0.8, 1.2], biases and means normal with deviation 0.05."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = seeded_tree(v, rng)
            continue
        s = tuple(v.shape)
        if k == "kernel":
            a = rng.normal(0, np.sqrt(1.0 / np.prod(s[:-1])), s)
        elif k in ("scale", "var"):
            a = rng.uniform(0.8, 1.2, s)
        else:
            a = rng.normal(0, 0.05, s)
        out[k] = a.astype(np.float32)
    return out


def backbone_tree(module, seed=1) -> dict:
    """Seeded weights for a flax backbone module, in its init's shapes."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 120, 120, 3))))
    return seeded_tree(dict(shapes), np.random.default_rng(seed))


def crops(b=2, seed=0):
    u8 = np.random.default_rng(seed).integers(0, 256, (b, 120, 120, 3))
    return ((u8 - 127.5) / 128.0).astype(np.float32)


def test_registry_equals_jax():
    """The JAX registry's 29 names, and ViT-B/16 and HRNetV2-W18, which the
    port alone has."""
    assert available_backbones() == sorted(jax_names()
                                           + ["vit_b16", "hrnetv2_w18"])
    assert len(available_backbones()) == 31


@pytest.mark.parametrize("arch", jax_names())
def test_state_dict_shapes_equal_jax_init(arch):
    """Every registered name builds, and SynergyNet(arch)'s state dict has
    exactly the JAX init's leaves (backbone and both synergy MLPs) at the
    same shapes, through convert.py's path mapping."""
    model = JaxSynergyNet(arch=arch)
    want = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 120, 120, 3)),
        method=JaxSynergyNet.init_all))
    want = _shapes({k: want[k] for k in ("params", "batch_stats")})
    with torch.device("meta"):
        port = SynergyNet(arch=arch)
    got = _shapes(flax_from_state_dict(
        {k: torch.zeros(v.shape) for k, v in port.state_dict().items()}))
    assert got == want


# One representative per distinct code path: the MobileNetV1 widths (the
# 8-channel floor at 0.25), a MobileNetV2 width, BasicBlock and Bottleneck,
# grouped and wide bottlenecks, GhostNet's ghost modules and squeeze-excite,
# ResNeSt with radix 2, radix 1 (the sigmoid) over 4 cardinal groups,
# radix 4, radix 2 over 2 groups (rSoftMax's transpose), and the texture
# head.
FORWARD_CASES = [
    ("mobilenet_1", {}), ("mobilenet_1_0.25", {}), ("mobilenet_v2_0.5", {}),
    ("resnet18", {}), ("resnet50", {}), ("resnext50_32x4d", {}),
    ("wide_resnet50_2", {}), ("ghostnet", {}), ("resnest50", {}),
    ("resnest50_fast_1s4x24d", {}), ("resnest50_fast_4s1x64d", {}),
    ("resnest50_fast_2s2x40d", {}),
    ("ghostnet", {"with_texture": True}),
]


@pytest.fixture(scope="module")
def forward_weights():
    cache = {}

    def get(arch, kw):
        key = (arch, tuple(sorted(kw)))
        if key not in cache:
            cache[key] = backbone_tree(jax_backbone(arch, **kw))
        return cache[key]
    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kw", FORWARD_CASES,
                         ids=[a + ("+texture" if k else "")
                              for a, k in FORWARD_CASES])
def test_forward_matches_jax(arch, kw, dtype, forward_weights):
    """Eval forward against ``apply(..., train=False)`` at 120x120, batch
    2. The bf16 model stores its convs in bf16 as serving does
    (``cast_layers_``: kernels and biases rounded once, as flax rounds them
    per call)."""
    variables = forward_weights(arch, kw)
    x = crops()
    jm = jax_backbone(arch, dtype=getattr(jnp, dtype), **kw)
    want_p, want_f = jax.jit(lambda v, x: jm.apply(v, x))(
        variables, jnp.asarray(x))
    tm = make_backbone(arch, dtype=getattr(torch, dtype), **kw)
    tm.load_state_dict(state_dict_from_flax(variables))
    cast_layers_(tm, getattr(torch, dtype))
    with torch.no_grad():
        p, f = tm.eval()(torch.from_numpy(x))
    assert p.dtype == f.dtype == torch.float32
    assert p.shape == (2, 62) and f.shape == tuple(want_f.shape)
    assert np.abs(np.asarray(want_p)).max() > 0.1     # a live network
    atol = FP32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(p.numpy(), np.asarray(want_p), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(f.numpy(), np.asarray(want_f), rtol=0,
                               atol=atol)


def test_texture_head_is_sliced_off():
    """With the texture branch the head has 102 outputs, and the backbone
    returns the first 62: the parameters of the model without it."""
    tm = make_backbone("resnet18", with_texture=True).eval()
    base = make_backbone("resnet18").eval()
    base.load_state_dict({k: v for k, v in tm.state_dict().items()
                          if "fc_texture" not in k})
    x = torch.from_numpy(crops(1))
    with torch.no_grad():
        head = tm.ParamHead_0(tm(x)[1])
        assert head.shape == (1, 102)
        assert torch.equal(tm(x)[0], head[:, :62])
        assert torch.equal(tm(x)[0], base(x)[0])


@pytest.mark.parametrize("hw,s", [((15, 15), 2), ((30, 30), 2), ((8, 8), 2),
                                  ((7, 9), 2), ((15, 8), 2)])
def test_resnest_pools_match_jax(hw, s):
    """The avg_down shortcut (``ceil_mode=True``, padding left out of the
    mean) against the JAX package's right/bottom padding with
    ``count_include_pad=False``, and the avd pool (3x3, stride s, padding
    1, ``count_include_pad=True``), at the odd sizes 120x120 reaches
    (15 -> 8). Small integers keep every window sum exact, so the results
    are equal bit for bit."""
    x = np.random.default_rng(hw[0]).integers(0, 256, (2, *hw, 5)).astype(
        np.float32)
    pad_h, pad_w = (-(hw[0] - s)) % s, (-(hw[1] - s)) % s
    want_down = fnn.avg_pool(jnp.asarray(x), (s, s), strides=(s, s),
                             padding=((0, pad_h), (0, pad_w)),
                             count_include_pad=False)
    want_avd = fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(s, s),
                            padding=((1, 1), (1, 1)), count_include_pad=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    down = F.avg_pool2d(xt, s, s, ceil_mode=True, count_include_pad=False)
    avd = F.avg_pool2d(xt, 3, s, 1, count_include_pad=True)
    assert down.shape[2:] == want_down.shape[1:3]
    assert np.array_equal(down.permute(0, 2, 3, 1).numpy(),
                          np.asarray(want_down))
    np.testing.assert_allclose(avd.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_avd), rtol=1e-6, atol=0)
