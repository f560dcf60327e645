"""The port's detection stack against the JAX package: anchors, box
decode, bit-identical greedy NMS, and the folded s2d8 FaceBoxesNet on
converted JAX weights (f32, atol 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu.detect import anchors as janchors
from synergynet_tpu.detect.detector import FaceBoxes as JaxFaceBoxes
from synergynet_tpu.detect.net import space_to_depth as jax_s2d
from synergynet_tpu.detect.nms import greedy_nms_mask as jax_nms
from synergynet_tpu.detect.torch_import import (random_init_variables,
                                                save_variables_npz)
from synergynet_tpu_torch.detect import anchors as tanchors
from synergynet_tpu_torch.detect import detector as tdetector
from synergynet_tpu_torch.detect.detector import FaceBoxes
from synergynet_tpu_torch.detect.net import FaceBoxesNet, space_to_depth
from synergynet_tpu_torch.detect.nms import greedy_nms_mask, pairwise_iou
from synergynet_tpu_torch.convert import faceboxes_state_dict

torch.set_num_threads(2)


@pytest.mark.parametrize("hw", [(720, 1088), (256, 384)])
def test_anchors_equal(hw):
    got = tanchors.generate_anchors(*hw)
    want = janchors.generate_anchors(*hw)
    assert np.array_equal(got, want)
    assert got.shape == (tanchors.num_anchors(*hw), 4)
    if hw == (720, 1088):
        assert got.shape[0] == 16680


def test_decode_boxes_matches(rng):
    anchors = janchors.generate_anchors(256, 384)
    loc = rng.normal(0, 1, (2, anchors.shape[0], 4)).astype(np.float32)
    want = np.asarray(janchors.decode_boxes(jnp.asarray(loc),
                                            jnp.asarray(anchors)))
    got = tanchors.decode_boxes(torch.from_numpy(loc),
                                torch.from_numpy(anchors.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _random_boxes(rng, n, span=200.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _chain_boxes(n):
    """Boxes sliding by 10 px: each overlaps its neighbour at IoU 0.6 and
    the one after next at 0.33, so greedy keeps every third box and the
    suppression chain runs the whole length."""
    x = np.arange(n, dtype=np.float32) * 10.0
    return np.stack([x, np.zeros(n), x + 49.0, np.full(n, 49.0)],
                    1).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "dense", "chain", "padding"])
def test_nms_bit_identical_to_jax(case, rng):
    if case == "random":
        boxes = np.stack([_random_boxes(rng, 200) for _ in range(3)])
        valid = np.ones((3, 200), bool)
    elif case == "dense":       # heavy overlap: many interacting boxes
        boxes = np.stack([_random_boxes(rng, 300, span=60.0)
                          for _ in range(2)])
        valid = rng.uniform(size=(2, 300)) < 0.9
    elif case == "chain":
        boxes = _chain_boxes(150)[None]
        valid = np.ones((1, 150), bool)
    else:                       # padding rows duplicate real boxes
        boxes = np.concatenate([_random_boxes(rng, 64)] * 2)[None]
        valid = np.arange(128)[None] < 64
    got = greedy_nms_mask(torch.from_numpy(boxes),
                          torch.from_numpy(valid), 0.3).numpy()
    for i in range(boxes.shape[0]):
        want = np.asarray(jax_nms(jnp.asarray(boxes[i]),
                                  jnp.asarray(valid[i]), 0.3))
        assert np.array_equal(got[i], want)
        assert not np.any(got[i] & ~valid[i])
    if case == "chain":
        assert np.array_equal(got[0], np.arange(150) % 3 == 0)


def test_pairwise_iou_inclusive_area():
    b = torch.tensor([[0.0, 0.0, 9.0, 9.0]])
    assert float(pairwise_iou(b)[0, 0]) == 1.0


@pytest.fixture(scope="module")
def jax_det():
    return JaxFaceBoxes(variables=random_init_variables())


def test_detector_folds_like_jax(jax_det):
    """The raw JAX random-init tree goes through the port's fold +
    s2d8 conversion to the JAX detector's own folded tree."""
    det = FaceBoxes(variables=jax.device_get(random_init_variables()),
                    device="cpu")
    want = faceboxes_state_dict(jax.device_get(jax_det.variables))
    got = faceboxes_state_dict(det.variables)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_net_matches_jax_f32(jax_det, rng):
    h, w = 256, 384
    img = rng.uniform(-120, 140, (2, h, w, 3)).astype(np.float32)
    x = np.ascontiguousarray(jax_s2d(img, 8))
    jloc, jconf = jax_det.net.apply(jax_det.variables, jnp.asarray(x),
                                    train=False)
    det = FaceBoxes(variables=jax.device_get(jax_det.variables),
                    device="cpu")
    with torch.no_grad():
        loc, conf = det.net(torch.from_numpy(x))
    assert loc.shape == (2, tanchors.num_anchors(h, w), 4)
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=0,
                               atol=1e-4)


def test_space_to_depth_matches(rng):
    img = rng.uniform(0, 255, (2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(jax_s2d(img, 8))
    assert np.array_equal(space_to_depth(torch.from_numpy(img), 8).numpy(),
                          want)


def test_stem_modes():
    FaceBoxesNet(stem_mode="xla")
    assert FaceBoxesNet(stem_mode="pallas").stem_mode == "pallas"
    with pytest.raises(ValueError):
        FaceBoxesNet(stem_mode="xlaa")


def test_seeded_random_init_and_asset_cache(tmp_path, monkeypatch,
                                            jax_det):
    """No weights: the JAX package's cached tree when <assets>/faceboxes.npz
    exists, else a seeded init that a seed reproduces."""
    monkeypatch.setattr(tdetector, "asset_dir", lambda: str(tmp_path))
    a = FaceBoxes(seed=1, device="cpu").variables["params"]
    b = FaceBoxes(seed=1, device="cpu").variables["params"]
    c = FaceBoxes(seed=2, device="cpu").variables["params"]
    assert np.array_equal(a["conv2"]["conv"]["kernel"],
                          b["conv2"]["conv"]["kernel"])
    assert not np.array_equal(a["conv2"]["conv"]["kernel"],
                              c["conv2"]["conv"]["kernel"])
    assert a["conv1_s2d8"]["kernel"].shape == (2, 2, 192, 192)

    save_variables_npz(str(tmp_path / "faceboxes.npz"),
                       jax.device_get(random_init_variables()))
    got = faceboxes_state_dict(FaceBoxes(device="cpu").variables)
    want = faceboxes_state_dict(jax.device_get(jax_det.variables))
    for k in want:
        assert torch.equal(got[k], want[k]), k
