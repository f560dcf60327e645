"""The port's detector importer (``detect/torch_import.py``) and the
FaceBoxes topologies that reference weights feed, against the JAX
package, on a ``FaceBoxesProd``-layout state dict made from a numpy seed
(the released checkpoint is not in the repository).

Each topology (the folded stem_r=8 net serving runs, stem_r=4 folded and
unfolded, the 3-channel 7x7/4 stem folded and unfolded) loads the same
saved ``.pth`` through ``FaceBoxes(weights_path=...)`` in both packages and
must hold the same converted tree and give the JAX detector's detections on
a seeded frame, face for face (f32 on both sides; boxes within
``tests/test_torch_api.py``'s BOXES tolerance, scores within 1e-4). The
frame keeps every candidate score more than 1e-3 from the 0.5 visibility
threshold, checked in the test, so rounding cannot move a face across it.
"""

import os

import jax
import numpy as np
import pytest
import torch

from synergynet_tpu.detect import torch_import as jti
from synergynet_tpu.detect.detector import FaceBoxes as JaxFaceBoxes
from synergynet_tpu_torch.convert import state_dict_from_flax
from synergynet_tpu_torch.detect import FaceBoxes
from synergynet_tpu_torch.detect import torch_import as tti
from synergynet_tpu_torch.detect.detector import (JAX_SEED0_INIT,
                                                  VIS_THRESHOLD,
                                                  prepare_frame)

torch.set_num_threads(2)

BOXES = dict(rtol=1e-4, atol=0.05)      # tests/test_torch_api.py
FRAME = ((120, 160), 1)                 # (height, width), seed


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), (
                v if isinstance(v, jax.ShapeDtypeStruct) else np.asarray(v))


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """The seeded reference checkpoint, saved as ``FaceBoxesProd.pth`` is:
    a plain state dict with DataParallel ``module.`` prefixes."""
    sd = tti.seeded_faceboxes_state_dict(0)
    path = os.path.join(tmp_path_factory.mktemp("fb"), "FaceBoxesProd.pth")
    torch.save({"module." + k: v for k, v in sd.items()}, path)
    return path


def _frame():
    hw, seed = FRAME
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)


def test_expected_shapes_are_the_jax_init_tree():
    """The reference names and shapes convert to exactly the leaves of the
    JAX package's unfolded FaceBoxesNet init."""
    sd = tti.seeded_faceboxes_state_dict(1)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        tti.expected_torch_shapes()
    want = jax.eval_shape(lambda: jti.random_init_variables(0))
    got = dict(_leaves(tti.convert_torch_state_dict(sd)))
    assert {k: v.shape for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in _leaves(want)}


def test_convert_torch_state_dict_equals_jax(pth):
    sd = torch.load(pth, weights_only=True)
    got = tti.convert_torch_state_dict(sd)
    _assert_trees_equal(got, jax.device_get(jti.convert_torch_state_dict(sd)))
    assert all(isinstance(v, np.ndarray) for _, v in _leaves(got))


def test_npz_trees_read_in_both_packages(pth, tmp_path):
    tree = tti.load_faceboxes_variables(pth)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    tti.save_variables_npz(ours, tree)
    jti.save_variables_npz(theirs, tree)
    _assert_trees_equal(jax.device_get(jti.load_variables_npz(ours)), tree)
    _assert_trees_equal(tti.load_variables_npz(theirs), tree)
    _assert_trees_equal(tti.load_faceboxes_variables(theirs), tree)


def test_default_weights_without_a_path(monkeypatch, tmp_path):
    from synergynet_tpu_torch.detect import detector
    monkeypatch.setattr(detector, "asset_dir", lambda: str(tmp_path))
    _assert_trees_equal(tti.load_faceboxes_variables(),
                        tti.load_variables_npz(JAX_SEED0_INIT))
    _assert_trees_equal(tti.load_faceboxes_variables(seed=3),
                        detector.random_init_variables(3))


TOPOLOGIES = [
    dict(),                                  # folded stem_r=8 (serving)
    dict(stem_r=4),                          # folded stem_r=4
    dict(stem_r=4, fold_bn=False),           # unfolded stem_r=4
    dict(stem_s2d=False),                    # folded 3-channel 7x7/4
    dict(stem_s2d=False, fold_bn=False),     # unfolded 3-channel 7x7/4
]


@pytest.mark.parametrize("kw", TOPOLOGIES, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "s2d8")
def test_topology_matches_jax(pth, kw):
    jdet = JaxFaceBoxes(weights_path=pth, **kw)
    det = FaceBoxes(weights_path=pth, device="cpu", **kw)
    assert (det.stem_r, det.fold_bn) == (jdet.stem_r, jdet.fold_bn)
    want_sd = state_dict_from_flax(jax.device_get(jdet.variables))
    got_sd = state_dict_from_flax(det.variables)
    assert sorted(got_sd) == sorted(want_sd)
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k

    img = _frame()
    _, packed, true_hw, _ = prepare_frame(img, det.stem_r, "cpu")
    with torch.no_grad():
        scores, _ = det.candidates(packed[None], true_hw[None])
    valid = scores[scores > 0]
    assert (valid - VIS_THRESHOLD).abs().min() > 1e-3
    jd, jc = jdet.detect_raw(img)
    td, tc = det.detect_raw(img)
    assert tc == jc > 0
    np.testing.assert_allclose(td[:tc, :4], jd[:jc, :4], **BOXES)
    np.testing.assert_allclose(td[:tc, 4], jd[:jc, 4], rtol=0, atol=1e-4)
    assert det(img) == [list(map(float, td[i])) for i in range(tc)]


def test_pre_converted_and_folded_trees(pth):
    """An already folded tree (conv bias present) converts to stem_r=8
    directly, a ``conv1_s2d8`` tree is taken as it is, and the latter with
    ``stem_s2d=False`` raises with the JAX package's message."""
    raw = tti.load_faceboxes_variables(pth)
    s2d8 = FaceBoxes(raw, device="cpu").variables
    folded = FaceBoxes(raw, stem_r=4, device="cpu").variables
    from synergynet_tpu_torch.detect.net import fold_bn_variables
    folded7 = fold_bn_variables(raw)
    for tree in (folded7, s2d8):
        det = FaceBoxes(tree, device="cpu")
        assert det.stem_r == 8 and det.fold_bn
        _assert_trees_equal(det.variables, s2d8)
    assert folded["params"]["conv1"]["conv"]["kernel"].shape == (2, 2, 48, 48)
    with pytest.raises(ValueError) as port:
        FaceBoxes(s2d8, stem_s2d=False, device="cpu")
    with pytest.raises(ValueError) as ref:
        JaxFaceBoxes(jax.tree_util.tree_map(np.asarray, s2d8),
                     stem_s2d=False)
    assert str(port.value) == str(ref.value)
