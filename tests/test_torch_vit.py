"""The port's Vision Transformer regressor and the crop size of the serving
API.

- ``vit_b16``'s family at a small size (depth 2, width 128 in 2 heads of
  64, MLP 512, 32-pixel crops) against the benchmark's plain float32
  reference (``perfbench/reference/regressors/vit_b16.py``) on a seeded
  tree: in float32 within 1e-5, in bf16 within a rounding tolerance that
  the reference in fp8 exceeds;
- the weight bridge both ways with the learned embeddings ``cls`` and
  ``pos_embedding``, and the seeded init of the new leaves;
- the attention function against an explicit softmax product, and its
  count in the launch table;
- the API's crop: ``process_batch`` and ``get_all_outputs`` feed the
  backbone crops of the API's side (96 through MobileNetV2, 120 as
  before), and a ViT whose position embedding does not fit the API's crop
  raises;
- the LANCZOS4 host crop's int32 guard.
"""

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.reference.nets import merge
from perfbench.reference.precision import Precision
from perfbench.reference.regressors import vit_b16 as ref
from synergynet_tpu_torch.convert import (flax_from_state_dict,
                                          state_dict_from_flax,
                                          synergy_state_dict)
from synergynet_tpu_torch.nn import SynergyNet
from synergynet_tpu_torch.nn.attention import attention
from synergynet_tpu_torch.nn.layers import cast_layers_
from synergynet_tpu_torch.nn.synergy import init_synergy_variables
from synergynet_tpu_torch.ops.cuda_build import launches

torch.set_num_threads(2)

SMALL = dict(patch=16, width=128, depth=2, heads=2, mlp_dim=512,
             image_size=32)
SMALL_SPEC = dict(width=128, depth=2, mlp=512, patch=16, crop=32)
# bf16 keeps 8 significant bits: every GEMM operand, each block's output
# and the residual stream round at 2^-9 relative, and over two blocks these
# roundings read ~1.5% of the 62 parameters' norm (seeds 3-5). fp8 e4m3
# (4 bits) in the reference reads ~13%, so 5% tells the two apart.
BF16_REL = 0.05


def _tree(seed):
    return weights.draw(ref.spec(**SMALL_SPEC), seed, "cpu")


def _crops(n, seed, side=32):
    g = torch.Generator().manual_seed(seed)
    u8 = torch.randint(0, 256, (n, side, side, 3), generator=g)
    return (u8.float() - 127.5) / 128.0


def _reference(tree, x, kind="f32"):
    return ref.forward(Precision(kind), merge(tree["params"],
                                              tree["batch_stats"])[
        "backbone"], x)


def _port(tree, dtype):
    model = SynergyNet("vit_b16", dtype=dtype, **SMALL)
    model.load_state_dict(synergy_state_dict(weights.numpy_tree(tree)))
    return cast_layers_(model, dtype).eval()


def _rel(got, want):
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


@pytest.mark.parametrize("seed", [3, 4])
def test_vit_f32_matches_the_reference(seed):
    tree, x = _tree(seed), _crops(6, seed)
    with torch.no_grad():
        got, feat = _port(tree, torch.float32)(x)
    assert got.shape == (6, 62) and feat.shape == (6, 128)
    assert _rel(got, _reference(tree, x)) < 1e-5


@pytest.mark.parametrize("seed", [3, 5])
def test_vit_bf16_within_rounding_and_fp8_outside(seed):
    tree, x = _tree(seed), _crops(6, seed)
    with torch.no_grad():
        got, _ = _port(tree, torch.bfloat16)(x)
    want = _reference(tree, x)
    assert got.dtype == torch.float32
    assert _rel(got, want) < BF16_REL
    assert _rel(_reference(tree, x, "fp8"), want) > BF16_REL


def test_vit_weight_bridge_round_trip_and_seeded_init():
    """The flax tree's ``cls`` (1, 1, D) and ``pos_embedding`` (1, T, D)
    pass through the bridge both ways unchanged; the seeded init draws the
    class token 0, the position embedding at std 0.02, LayerNorm 1 / 0."""
    model = SynergyNet("vit_b16", **SMALL)
    variables = init_synergy_variables(model,
                                       torch.Generator().manual_seed(0))
    bb = variables["params"]["backbone"]
    assert bb["cls"].shape == (1, 1, 128) and not bb["cls"].any()
    assert bb["pos_embedding"].shape == (1, 5, 128)
    assert 0.01 < bb["pos_embedding"].std() < 0.03
    ln = bb["encoderblock_1"]["LayerNorm_1"]
    assert (ln["scale"] == 1).all() and not ln["bias"].any()
    assert bb["encoderblock_0"]["qkv"]["kernel"].shape == (128, 384)
    state = model.state_dict()
    back = state_dict_from_flax(flax_from_state_dict(state))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    tree = weights.numpy_tree(_tree(3))
    again = flax_from_state_dict(synergy_state_dict(tree))
    for k in ("cls", "pos_embedding"):
        np.testing.assert_array_equal(again["params"]["backbone"][k],
                                      tree["params"]["backbone"][k])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-2)])
def test_attention_is_the_softmax_product_and_counts(dtype, tol):
    """The CPU path against ``softmax(q k^T / sqrt(d)) v`` in float64 on
    the same (rounded) inputs; bf16 rounds the result once (2^-9)."""
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 17, 3, 3, 8, generator=g).to(dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)               # strided, as served
    before = launches["attention"]
    out = attention(q, k, v)
    assert launches["attention"] == before + 1
    assert out.shape == (2, 3, 17, 8) and out.dtype == dtype
    q64, k64, v64 = (t.double() for t in (q, k, v))
    want = torch.softmax(q64 @ k64.transpose(-1, -2) / 8 ** 0.5, -1) @ v64
    torch.testing.assert_close(out.double(), want, rtol=tol, atol=tol)


# -- the API's crop -----------------------------------------------------------

@pytest.fixture(scope="module")
def detector():
    from synergynet_tpu_torch.detect.detector import (FaceBoxes,
                                                      random_init_variables)
    return FaceBoxes(random_init_variables(0), device="cpu")


def _frames(seed):
    from synergynet_tpu_torch.detect.detector import prepare_frame
    img = np.random.default_rng(seed).integers(0, 256, (720, 1088, 3),
                                               np.uint8)
    return img, [x[None] for x in prepare_frame(img, 8, "cpu")[:3]]


def _spy(api):
    seen = []
    api.model.backbone.register_forward_pre_hook(
        lambda m, args: seen.append(tuple(args[0].shape)))
    return seen


@pytest.mark.parametrize("crop", [96, 120])
def test_process_batch_and_host_crops_at_the_api_crop(detector, crop):
    """A MobileNetV2 API at ``crop``: ``process_batch`` feeds the backbone
    (N, crop, crop, 3), as do ``get_all_outputs`` and ``process_crops``;
    at 120, the default, the outputs equal the default API's bit for
    bit."""
    from synergynet_tpu_torch.pipeline import (FusedFrameEngine,
                                               SynergyNet3DMM,
                                               preprocess_crops)
    api = SynergyNet3DMM(variables="trained", device="cpu", crop=crop)
    assert api.crop == crop
    engine = FusedFrameEngine(api, detector=detector, max_faces=2)
    seen = _spy(api)
    img, frames = _frames(7)
    out = engine.process_batch(*frames)
    assert seen == [(2, crop, crop, 3)]
    rects = [np.array([300.0, 200.0, 520.0, 460.0, 0.9])]
    api.get_all_outputs(img, rects)
    assert seen[1] == (1, crop, crop, 3)
    rois = [np.array([290.0, 190.0, 530.0, 470.0])]
    crops = preprocess_crops(img, rois, device="cpu", size=crop)
    assert crops.shape == (1, crop, crop, 3)
    api.process_crops(crops, rois)
    assert seen[2] == (1, crop, crop, 3)
    if crop == 120:
        default = SynergyNet3DMM(variables="trained", device="cpu")
        assert default.crop == 120
        want = FusedFrameEngine(default, detector=detector,
                                max_faces=2).process_batch(*frames)
        for a, b in zip(out, want):
            assert torch.equal(a, b)
    else:
        with pytest.raises(ValueError, match="crops at"):
            api.process_crops(preprocess_crops(img, rois, device="cpu"),
                              rois)


@pytest.fixture()
def small_vit(monkeypatch):
    from synergynet_tpu_torch.nn import backbones
    from synergynet_tpu_torch.nn.backbones.vit import VisionTransformer
    monkeypatch.setattr(backbones, "_REGISTRY", dict(backbones._REGISTRY))
    backbones.register_backbone(
        "vit_small", lambda **kw: VisionTransformer(**SMALL, **kw))


def test_vit_at_a_crop_its_embedding_does_not_fit_raises(small_vit):
    from synergynet_tpu_torch.pipeline import SynergyNet3DMM
    with pytest.raises(ValueError, match="takes 32 x 32 crops"):
        SynergyNet3DMM("vit_small", device="cpu", crop=48)
    assert SynergyNet3DMM("vit_small", device="cpu", crop=32).crop == 32
    # No crop given: the backbone's fixed side, else SynergyNet's 120.
    assert SynergyNet3DMM("vit_small", device="cpu").crop == 32
    assert SynergyNet3DMM(device="cpu").crop == 120


def test_vit_process_batch_counts_a_launch_a_block(small_vit, detector):
    """``process_batch`` through a ViT API at its crop: one attention call
    a block, and the faces cropped at 32."""
    from synergynet_tpu_torch.pipeline import FusedFrameEngine, SynergyNet3DMM
    api = SynergyNet3DMM("vit_small", dtype=torch.bfloat16, device="cpu",
                         crop=32)
    engine = FusedFrameEngine(api, detector=detector, max_faces=2)
    seen = _spy(api)
    before = launches["attention"]
    out = engine.process_batch(*_frames(8)[1])
    assert launches["attention"] == before + SMALL["depth"]
    assert seen == [(2, 32, 32, 3)]
    assert out[3].shape == (1, 2, 62) and torch.isfinite(out[3]).all()


def test_lanczos4_sums_fit_int32_at_every_size():
    """The LANCZOS4 emulation sums int32 products: its docstring's bound
    (a row's positive tap sum at most P = 2780, its negative at most
    N = 732, so 255 (P^2 + N^2) plus the rounding term fits 2^31 - 1)
    holds on a dense grid of fractions and at every output side up to
    512 from sources small and large."""
    from synergynet_tpu_torch.ops import resize

    def sums(w):
        w = w.astype(np.int64)
        return (np.where(w > 0, w, 0).sum(-1).max(),
                np.where(w < 0, -w, 0).sum(-1).max())
    fx = (np.arange(2 ** 20) / 2 ** 20).astype(np.float32)
    grid = np.rint(resize.lanczos4_coefficients(fx)
                   * np.float32(resize._COEF_SCALE))
    assert sums(grid) == (2780, 732)
    for size in range(1, 513):
        for n_src in (1, 2, 3, 7, 40, 97, 120, 224, 300, 720, 1088):
            p, n = sums(resize._lanczos4_taps(n_src, size)[1])
            assert p <= 2780 and n <= 732, (n_src, size)
    assert 255 * (2780 ** 2 + 732 ** 2) + 2 ** 21 < 2 ** 31 - 1
