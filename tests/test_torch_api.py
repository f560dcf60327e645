"""The port's packaged two-stage API and the detector's host calls against
the JAX package, on the CPU, f32, on the same seeded inputs and weights.

- ``square_box`` / ``crop_img`` equal; ``preprocess_crops`` equals the JAX
  package's (``cv2.resize`` of ``crop_img``) bit for bit for LANCZOS4 and
  INTER_LINEAR, on crops that cross every frame edge, an identity 120 px
  crop, down- and upscales and rois at .5;
- ``process_crops`` at 0, 1, 5 and 17 faces and ``get_all_outputs`` with
  and without rects: param62 within 1e-4 (``test_torch_pipeline.py``'s
  stage 3), landmarks, meshes and poses at CHAIN (rtol 1e-4 / atol 1e-2:
  the param62 error chained through the decode);
- ``FaceBoxes.detect_raw`` / ``__call__``: equal counts and rows at
  ``test_stage1_detector``'s tolerance. The random-init detector's scores
  are mostly saturated; each frame here is checked to keep every
  candidate's score at least 1e-3 from the 0.5 visibility threshold, so a
  last-bit difference cannot flip the count;
- ``select_detections`` and ``nms_indices`` exact, soft-NMS scores within
  1e-5, the gather and hybrid crops at the JAX package's own crop
  tolerance; the plain twin of kernel C1 against JAX's four-tap gather on
  whole-pixel, empty, negative, off-frame, up- and down-scaled and
  batched rois (``BILINEAR_ATOL``), its taps equal to numpy float32's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu.detect.detector import FaceBoxes as JaxFaceBoxes
from synergynet_tpu.detect.detector import \
    select_detections as jax_select_detections
from synergynet_tpu.detect.nms import nms_indices as jax_nms_indices
from synergynet_tpu.detect.nms import soft_nms as jax_soft_nms
from synergynet_tpu.detect.nms import soft_nms_device as jax_soft_nms_device
from synergynet_tpu.detect.torch_import import random_init_variables
from synergynet_tpu.mm3d.codec import whiten as jax_whiten
from synergynet_tpu.mm3d.crop import crop_img as jax_crop_img
from synergynet_tpu.mm3d.crop import square_box as jax_square_box
from synergynet_tpu.pipeline import SynergyNet3DMM as JaxApi
from synergynet_tpu.pipeline.api import preprocess_crops as jax_preprocess
from synergynet_tpu.pipeline.device_crop import \
    crop_resize_bilinear as jax_bilinear
from synergynet_tpu.pipeline.device_crop import \
    crop_resize_hybrid as jax_hybrid
from synergynet_tpu_torch.detect import (FaceBoxes, nms_indices,
                                         select_detections, soft_nms,
                                         soft_nms_device)
from synergynet_tpu_torch.detect.detector import VIS_THRESHOLD, prepare_frame
from synergynet_tpu_torch.mm3d import (crop_img, dewhiten, load_param_pack,
                                       square_box, whiten)
from synergynet_tpu_torch.mm3d.crop import crop_rect
from synergynet_tpu_torch.ops.resize import lanczos4_coefficients
from synergynet_tpu_torch.pipeline.device_crop import crop_taps
from synergynet_tpu_torch.pipeline import (MAX_FACES_PER_BATCH,
                                           SynergyNet3DMM,
                                           crop_resize_bilinear,
                                           crop_resize_hybrid,
                                           crop_resize_matmul,
                                           preprocess_crops)

torch.set_num_threads(2)

P62 = dict(rtol=0, atol=1e-4)
CHAIN = dict(rtol=1e-4, atol=1e-2)
BOXES = dict(rtol=1e-4, atol=0.05)      # test_stage1_detector's tolerance


@pytest.fixture(scope="module")
def detectors():
    jdet = JaxFaceBoxes(variables=random_init_variables())
    host = jax.device_get(jdet.variables)
    return jdet, {mode: FaceBoxes(variables=host, device="cpu",
                                  stem_mode=mode)
                  for mode in (None, "pallas")}


@pytest.fixture(scope="module")
def apis(detectors):
    jdet, tdets = detectors
    return (JaxApi(variables="trained", detector=jdet),
            SynergyNet3DMM(variables="trained", device="cpu",
                           detector=tdets[None]))


def _noise(hw, seed):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)


# -- crop geometry -------------------------------------------------------------

RECTS = [[10.0, 20.0, 110.0, 140.0, 0.9], [-30.5, 4.5, 41.5, 77.5],
         [33.25, -12.75, 95.5, 60.5], [50.5, 40.5, 90.5, 81.5],
         [0.0, 0.0, 69.0, 49.0], [60.0, 30.0, 130.0, 120.0]]


@pytest.mark.parametrize("rect", RECTS)
def test_square_box_and_crop_img_match(rect):
    img = _noise((50, 70), 0)
    want = jax_square_box(rect)
    got = square_box(rect)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for roi in (rect, got):
        jc, tc = jax_crop_img(img, roi), crop_img(img, roi)
        assert tc.dtype == jc.dtype and np.array_equal(tc, jc)
    # Python's round: half to even, on the roi as float64
    assert np.array_equal(crop_img(img[..., 0], rect),
                          jax_crop_img(img, rect)[..., 0])


def _crop_cases():
    """(name, frame (h, w), rois): every edge and corner crossed, a crop
    larger than the frame, an identity crop, down- and upscales, .5 rois,
    non-square rois."""
    h, w = 150, 200
    edges = [[-40, 30, 60, 130], [150, 20, 250, 120], [50, -45, 150, 55],
             [60, 100, 160, 200], [-30, -30, 70, 70], [170, -20, 260, 70],
             [-25, 110, 75, 210], [160, 120, 230, 190], [-50, -60, 260, 210]]
    sizes = [[10 + s // 4, 5, 10 + s // 4 + s, 5 + s]
             for s in (60, 119, 200, 240, 241, 360, 480, 37)]
    return [
        ("edges", (h, w), edges),
        ("identity", (h, w), [[30, 12, 150, 132], [0, 0, 120, 120]]),
        ("sizes", (h, w), sizes),
        ("halves", (h, w), [[10.5, 20.5, 130.5, 140.5],
                            [11.5, 21.5, 77.5, 87.5],
                            [-3.5, 98.5, 61.5, 163.5]]),
        ("rect", (h, w), [[20, 30, 170, 90], [5, 5, 45, 145]]),
    ]


CROP_CASES = _crop_cases()


@pytest.mark.parametrize("interpolation", ["lanczos4", "linear"])
@pytest.mark.parametrize("case", CROP_CASES, ids=[c[0] for c in CROP_CASES])
def test_preprocess_crops_equals_cv2(case, interpolation):
    _, hw, rois = case
    img = _noise(hw, 3)
    rois = [np.asarray(r, np.float64) for r in rois]
    want = jax_preprocess(img, rois, interpolation)
    got = preprocess_crops(img, rois, interpolation, device="cpu")
    assert got.dtype == np.uint8 and got.shape == (len(rois), 120, 120, 3)
    bad = (got != want).any(axis=(1, 2, 3))
    assert not bad.any(), f"crops {np.nonzero(bad)[0]} differ from cv2"
    if case[0] == "identity":
        assert np.array_equal(got[0], img[12:132, 30:150])


def test_lanczos4_sample_points_are_float32():
    """Rounding the sample point to float32 is what makes the taps cv2's:
    float64 points move some coefficients by one step at x2048."""
    n_src, n_dst = 241, 120
    d = np.arange(n_dst) + 0.5
    f64 = d * (1.0 / (n_dst / n_src)) - 0.5
    f32 = f64.astype(np.float32)
    w32 = np.rint(lanczos4_coefficients(f32 - np.floor(f32)) * 2048)
    frac64 = (f64 - np.floor(f64)).astype(np.float32)
    w64 = np.rint(lanczos4_coefficients(frac64) * 2048)
    assert (w32 != w64).any()
    unit = lanczos4_coefficients(np.zeros(1, np.float32))[0]
    assert np.array_equal(np.rint(unit * 2048), [0, 0, 0, 2048, 0, 0, 0, 0])


def test_preprocess_crops_rejects_unknown_interpolation():
    with pytest.raises(ValueError, match="interpolation"):
        preprocess_crops(_noise((40, 40), 0), [np.array([0, 0, 20, 20.])],
                         "cubic", device="cpu")


# -- the two-stage API -----------------------------------------------------------

def _rois(rng, n, hw=(240, 320)):
    """n square rois inside and across the frame's edges."""
    s = rng.uniform(50, 160, n)
    x = rng.uniform(-40, hw[1] - 20, n)
    y = rng.uniform(-40, hw[0] - 20, n)
    return np.stack([x, y, x + s, y + s], 1)


def _assert_outputs(got, want, p62=True):
    """(param62, lmk, dense, angles, t3d) against the JAX package's."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **(P62 if i == 0 and p62
                                             else CHAIN))


@pytest.mark.parametrize("n", [0, 1, 5, 17])
def test_process_crops_matches_jax(apis, n):
    japi, tapi = apis
    rng = np.random.default_rng(10 + n)
    img = _noise((240, 320), n)
    rois = _rois(rng, n)
    crops = jax_preprocess(img, rois) if n else np.zeros((0, 120, 120, 3),
                                                         np.uint8)
    want = japi.process_crops(crops, rois.astype(np.float32))
    got = tapi.process_crops(crops, rois.astype(np.float32))
    _assert_outputs(got, want)
    assert got[2].shape == (n, 3, 53215) and got[1].shape == (n, 3, 68)


def test_process_crops_does_not_depend_on_chunking(apis):
    """17 faces run as chunks of 16 + 1 equal each face run alone."""
    _, tapi = apis
    n = MAX_FACES_PER_BATCH + 1
    rng = np.random.default_rng(4)
    crops = rng.integers(0, 256, (n, 120, 120, 3), np.uint8)
    rois = _rois(rng, n).astype(np.float32)
    full = tapi.process_crops(crops, rois)
    for i in (0, 7, n - 1):
        one = tapi.process_crops(crops[i:i + 1], rois[i:i + 1])
        for f, o in zip(full, one):
            np.testing.assert_allclose(f[i], o[0], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("interpolation", ["lanczos4", "linear"])
def test_get_all_outputs_with_rects_matches_jax(apis, interpolation):
    japi, tapi = apis
    img = _noise((240, 320), 21)
    rects = [[40.0, 50.0, 140.0, 160.0, 0.99], [160.0, 60.0, 240.0, 150.0],
             [-20.5, 150.5, 60.5, 260.5], [250.0, -30.0, 340.0, 70.0],
             [100.25, 90.75, 170.5, 171.5]]
    want = japi.get_all_outputs(img, rects=rects, interpolation=interpolation)
    got = tapi.get_all_outputs(img, rects=rects, interpolation=interpolation)
    assert [len(x) for x in got] == [len(rects)] * 3
    for i in range(len(rects)):
        np.testing.assert_allclose(got[0][i], want[0][i], **CHAIN)
        np.testing.assert_allclose(got[1][i], want[1][i], **CHAIN)
        for k in range(2):
            np.testing.assert_allclose(got[2][i][k], want[2][i][k], **CHAIN)


def _overlaps(rect, hw):
    sx, sy, ex, ey = (int(round(float(v))) for v in square_box(rect))
    return ex > 0 and ey > 0 and sx < hw[1] and sy < hw[0]


def test_get_all_outputs_without_rects_matches_jax(apis):
    """The detector picks the faces (a small frame, so the random-init
    detector keeps tens, not 750): the port's own rects equal the JAX
    detector's, and the faces equal the JAX package's. Some of these wild
    boxes square to rois that miss the frame entirely, which the JAX
    package's ``crop_img`` cannot crop (it raises); those faces are held to
    the port's own zero crop instead."""
    japi, tapi = apis
    hw = (40, 56)
    img = _noise(hw, 0)
    jrects = japi.detector(img)
    rects = tapi.detector(img)
    assert 0 < len(rects) == len(jrects) < 750
    np.testing.assert_allclose(np.asarray(rects), np.asarray(jrects),
                               **BOXES)
    rois = [square_box(r) for r in rects]
    assert [crop_rect(r) for r in rois] == [crop_rect(square_box(r))
                                           for r in jrects]
    got = tapi.get_all_outputs(img)
    assert len(got[0]) == len(rects)
    inside = [i for i, r in enumerate(jrects) if _overlaps(r, hw)]
    outside = [i for i in range(len(rects)) if i not in inside]
    assert inside and outside
    want = japi.get_all_outputs(img, rects=[jrects[i] for i in inside])
    for j, i in enumerate(inside):
        np.testing.assert_allclose(got[0][i], want[0][j], **CHAIN)
        np.testing.assert_allclose(got[1][i], want[1][j], **CHAIN)
    blank = np.zeros((len(outside), 120, 120, 3), np.uint8)
    _, lmk, dense, _, _ = tapi.process_crops(blank, np.stack(
        [rois[i] for i in outside]).astype(np.float32))
    for j, i in enumerate(outside):
        np.testing.assert_allclose(got[0][i], lmk[j], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got[1][i], dense[j], rtol=1e-5,
                                   atol=1e-4)


def test_crops_that_miss_the_frame_or_are_empty_are_zero():
    """A roi that misses the frame crops to zeros; so does an empty roi (a
    degenerate detection), where ``cv2.resize`` raises."""
    img = _noise((40, 56), 1)
    rois = [np.array([23.2, -20.1, 35.2, -8.1]), np.array([60., 5., 90., 35.]),
            np.array([-40., 45., -2., 83.]), np.array([20., 10., 20., 10.]),
            np.array([10., 10., 30., 30.])]
    for interpolation in ("lanczos4", "linear"):
        crops = preprocess_crops(img, rois, interpolation, device="cpu")
        assert not crops[:4].any() and crops[4].any()
    for r, shape in zip(rois[:3], [(12, 12), (30, 30), (38, 38)]):
        c = crop_img(img, r)
        assert c.shape == shape + (3,) and not c.any()


def test_zero_faces(apis):
    japi, tapi = apis
    img = np.zeros((100, 100, 3), np.uint8)
    assert tapi.get_all_outputs(img, rects=[]) == ([], [], [])
    want = japi.process_crops(np.zeros((0, 120, 120, 3), np.uint8),
                              np.zeros((0, 4), np.float32))
    got = tapi.process_crops(np.zeros((0, 120, 120, 3), np.uint8),
                             np.zeros((0, 4), np.float32))
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(g.dtype == np.float32 for g in got)


def test_seeded_init_and_its_variables():
    """variables=None draws flax's init from the seed; the tree it keeps
    rebuilds the same model."""
    a = SynergyNet3DMM(device="cpu", seed=3)
    b = SynergyNet3DMM(variables=None, device="cpu", seed=3)
    c = SynergyNet3DMM(device="cpu", seed=4)
    crops = np.random.default_rng(0).integers(0, 256, (2, 120, 120, 3),
                                              np.uint8)
    rois = np.asarray([[0, 0, 120, 120]] * 2, np.float32)
    pa, pb, pc = (api.process_crops(crops, rois)[0] for api in (a, b, c))
    assert np.array_equal(pa, pb) and not np.allclose(pa, pc)
    again = SynergyNet3DMM(variables=a.variables, device="cpu")
    assert np.array_equal(again.process_crops(crops, rois)[0], pa)


def test_detector_property_is_lazy_and_on_the_api_device():
    api = SynergyNet3DMM(variables="trained", device="cpu")
    assert api._detector is None
    det = api.detector
    assert det.device == api.device and api.detector is det


def test_whiten_inverts_dewhiten():
    pack = load_param_pack()
    raw = torch.tensor(np.random.default_rng(0).normal(0, 1, (4, 62)),
                       dtype=torch.float32)
    got = whiten(raw, pack)
    from synergynet_tpu.mm3d import load_param_pack as jax_pack
    want = np.asarray(jax_whiten(jnp.asarray(raw.numpy()), jax_pack()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dewhiten(got, pack).numpy(), raw.numpy(),
                               rtol=1e-5, atol=1e-5)


# -- the detector's host calls -------------------------------------------------

DET_FRAMES = [((480, 640), 8), ((1080, 1440), 1), ((40, 56), 0),
              ((120, 160), 2)]


@pytest.fixture(scope="module")
def jax_dets(detectors):
    jdet, _ = detectors
    return {hw: jdet.detect_raw(_noise(hw, seed)) for hw, seed in DET_FRAMES}


@pytest.mark.parametrize("stem", [None, "pallas"])
@pytest.mark.parametrize("frame", DET_FRAMES, ids=lambda f: f"{f[0][0]}x"
                         f"{f[0][1]}")
def test_detector_host_calls_match_jax(detectors, jax_dets, frame, stem):
    _, tdets = detectors
    det = tdets[stem]
    hw, seed = frame
    img = _noise(hw, seed)
    # The frame keeps clear of the visibility threshold.
    _, packed, true_hw, _ = prepare_frame(img, 8, "cpu")
    with torch.no_grad():
        scores, _ = det.candidates(packed[None], true_hw[None])
    valid = scores[scores > 0]
    assert (valid - VIS_THRESHOLD).abs().min() > 1e-3
    jd, jc = jax_dets[hw]
    td, tc = det.detect_raw(img)
    assert tc == jc > 0 and td.shape == jd.shape and td.dtype == jd.dtype
    np.testing.assert_allclose(td[:tc, :4], jd[:jc, :4], **BOXES)
    np.testing.assert_allclose(td[:tc, 4], jd[:jc, 4], rtol=0, atol=1e-4)
    faces = det(img)
    assert len(faces) == tc
    assert faces == [list(map(float, td[i])) for i in range(tc)]


def _sparse_candidates(rng, a):
    scores = np.full(a, -1.0, np.float32)
    scores[rng.choice(a, 300, replace=False)] = rng.uniform(0.06, 0.45, 300)
    scores[rng.choice(a, 40, replace=False)] = rng.uniform(0.6, 0.99, 40)
    xy = rng.uniform(0, 900, (a, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(20, 200, (a, 2))], 1)
    return scores, boxes.astype(np.float32)


def _frame_candidates(detectors):
    _, tdets = detectors
    _, packed, true_hw, _ = prepare_frame(_noise((480, 640), 8), 8, "cpu")
    with torch.no_grad():
        s, b = tdets[None].candidates(packed[None], true_hw[None])
    return s[0].numpy(), b[0].numpy()


@pytest.mark.parametrize("top_k", [2048, 300])
@pytest.mark.parametrize("source", ["frame", "sparse"])
def test_select_detections_exact(detectors, source, top_k):
    if source == "frame":
        scores, boxes = _frame_candidates(detectors)
    else:
        scores, boxes = _sparse_candidates(np.random.default_rng(1), 16680)
    wd, wc = (np.asarray(x) for x in jax_select_detections(
        jnp.asarray(boxes), jnp.asarray(scores), top_k))
    gd, gc = select_detections(torch.tensor(boxes), torch.tensor(scores),
                               top_k)
    assert np.array_equal(gd.numpy(), wd) and int(gc) == int(wc)


def _chain_dets(n):
    x = np.arange(n, dtype=np.float32) * 10.0
    return np.stack([x, np.zeros(n), x + 49.0, np.full(n, 49.0),
                     np.linspace(0.9, 0.1, n)], 1).astype(np.float32)


def _nms_cases():
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 200, (300, 2))
    rand = np.concatenate([xy, xy + rng.uniform(5, 80, (300, 2)),
                           rng.uniform(0, 1, (300, 1))], 1).astype(np.float32)
    ties = rand.copy()
    ties[:, 4] = np.round(ties[:, 4], 1)     # many equal scores
    return {"random": rand, "ties": ties, "chain": _chain_dets(97),
            "one": rand[:1], "none": rand[:0]}


NMS_CASES = _nms_cases()


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_indices_exact(case):
    dets = NMS_CASES[case]
    want = jax_nms_indices(dets, 0.3) if len(dets) else []
    assert nms_indices(dets, 0.3, device="cpu") == want


@pytest.mark.parametrize("method", ["gaussian", "linear", "hard"])
def test_soft_nms_matches(method):
    dets = NMS_CASES["random"][:120]
    want = jax_soft_nms(dets, method=method)
    got = soft_nms(dets, method=method, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :4], want[:, :4])
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=1e-5)
    valid = np.arange(128) < 120
    pad = np.zeros((8, 5), np.float32)
    full = np.concatenate([dets, pad])
    wi, ws, wn = (np.asarray(x) for x in jax_soft_nms_device(
        jnp.asarray(full[:, :4]), jnp.asarray(full[:, 4]),
        jnp.asarray(valid), method=method))
    gi, gs, gn = soft_nms_device(torch.tensor(full[:, :4]),
                                 torch.tensor(full[:, 4]),
                                 torch.tensor(valid), method=method)
    assert int(gn) == int(wn)
    assert np.array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=0, atol=1e-5)


# -- the alternative device crops ------------------------------------------------

@pytest.mark.parametrize("which", ["bilinear", "hybrid"])
def test_crop_alternatives_match_jax_and_matmul(which):
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 255, (96, 128, 3)).astype(np.float32)
    rois = np.concatenate([_rois(rng, 5, (96, 128)),
                           [[-20.5, -10.5, 40.5, 50.5]]]).astype(np.float32)
    fn, jfn = {"bilinear": (crop_resize_bilinear, jax_bilinear),
               "hybrid": (crop_resize_hybrid, jax_hybrid)}[which]
    got = fn(torch.tensor(img)[None], torch.tensor(rois)[None], 32)[0]
    want = np.asarray(jfn(jnp.asarray(img), jnp.asarray(rois), 32))
    assert got.shape == (6, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    assert fn is crop_resize_matmul        # one implementation, JAX names


# Rois (B, N, 4) on (160, 224) frames, cropped to 120 x 120. Extents 24, 40,
# 72, 120, 200 and 360 put many sample coordinates exactly on whole pixels.
# JAX divides extent / 120 as a multiply by 1 / 120 (XLA), the twin and C1
# correctly rounded; the two give different floors only at extents such as
# 280, 312 and 344, which no case uses, so the taps agree. The extra rounding
# moves a sample coordinate c < 512 by at most ~2 ulps (6e-5), and so a
# weight: on 0-255 noise a value by at most 255 x 6e-5 per axis, ~0.03.
# BILINEAR_ATOL sits above that and far below what a tap moved by one pixel
# does to a value on noise (tens).
BILINEAR_ATOL = 0.05
BILINEAR_CASES = {
    "integer_coordinates": [[[x, y, x + e, y + e] for x, y, e in (
        (10, 20, 24), (30, 5, 40), (100, 60, 72), (50, 20, 120),
        (0, 0, 200), (-60, -90, 360), (150.4, 100.6, 40))]],
    "empty_and_negative_extents": [[
        [50, 60, 50, 60], [80, 40, 70, 30], [100.4, 20, 100.6, 90],
        [-10, -10, -30, -30], [223, 159, 223, 159], [300, 10, 250, 60],
        [20, 30, 90, 20]]],
    "off_frame": [[
        [-200, -200, -100, -100], [300, 10, 400, 110], [10, 170, 110, 270],
        [-50, -50, -1, -1], [-119.6, 40, 0.4, 160], [223.5, -10, 330, 90]]],
    "up_and_down_scales": [[
        [10, 10, 40, 40], [5, 5, 60, 65], [0, 0, 150, 150],
        [20, 5, 219, 155], [-30, -40, 220, 210], [100, 100, 101, 102]]],
    "batched": [[[10 + 20 * i + 7 * f, 15 * i - 5 * f, 70 + 30 * i + 7 * f,
                  60 + 25 * i - 5 * f] for i in range(4)] for f in range(3)],
}


@pytest.mark.parametrize("case", sorted(BILINEAR_CASES))
def test_crop_twin_matches_jax_bilinear(case):
    """The plain twin of kernel C1 (the CPU path of crop_resize_bilinear)
    against the JAX package's four-tap gather, frame by frame; at whole-
    pixel sample coordinates its taps carry weight 0 on the second tap and
    sit on the exact pixel."""
    rois = np.asarray(BILINEAR_CASES[case], np.float32)
    b = rois.shape[0]
    rng = np.random.default_rng(len(case))
    img = rng.uniform(0, 255, (b, 160, 224, 3)).astype(np.float32)
    got = crop_resize_bilinear(torch.tensor(img), torch.tensor(rois))
    assert got.shape == (*rois.shape[:2], 120, 120, 3)
    for f in range(b):
        want = np.asarray(jax_bilinear(jnp.asarray(img[f]),
                                       jnp.asarray(rois[f])))
        np.testing.assert_allclose(got[f].numpy(), want, rtol=0,
                                   atol=BILINEAR_ATOL)
    # The taps against the same arithmetic in numpy float32 (one rounding
    # an operation), at every coordinate; on a whole-pixel coordinate the
    # second tap's weight is 0.
    idx, frac = crop_taps(torch.tensor(rois), (160, 224))
    r = np.round(rois)
    d = np.arange(120, dtype=np.float32) + np.float32(0.5)
    whole = 0
    for axis, (lo, size) in enumerate(((1, 160), (0, 224))):
        start = r[..., lo, None]
        ext = r[..., lo + 2, None] - start
        top = np.maximum(ext - 1, 0)
        c = np.minimum(np.maximum(d * (ext / np.float32(120)) - 0.5, 0), top)
        c0 = np.floor(c)
        taps = np.stack([c0, np.minimum(c0 + 1, top)], -1) + start[..., None]
        np.testing.assert_array_equal(
            idx[..., axis, :, :].numpy(),
            np.where((taps >= 0) & (taps < size), taps, -1))
        np.testing.assert_array_equal(frac[..., axis, :].numpy(), c - c0)
        whole += int((c == c0).sum())
    if case == "integer_coordinates":
        assert whole > 600
