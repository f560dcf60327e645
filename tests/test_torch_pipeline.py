"""The port's FusedFrameEngine against the JAX one, f32, both detectors on
the same converted weights.

The comparison runs in stages, so that a discrete flip (a box crossing a
threshold on a last-bit difference) can neither hide nor fake a fault:
1. detector logits, scores and boxes within tolerance, on the same input;
2. the JAX side's scores and boxes fed to both selection steps: face
   scores, face count and rois equal exactly;
3. given the JAX rois, param62 (atol 1e-4); from the same param62,
   landmarks and pose (rtol 1e-5 / atol 1e-4) and the dense mesh (rtol 1e-4
   / atol 1e-3).

Outputs that chain the port's own param62 into the decode (stage 3's
second pass, ``__call__``, ``process_batch``) carry its <= 1e-4 error times
vertex coordinates (~100) and the roi scale (up to ~6): they get CHAIN, a
hundredth of a pixel (or degree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu.detect.anchors import decode_boxes as jax_decode_boxes
from synergynet_tpu.detect.detector import FaceBoxes as JaxFaceBoxes
from synergynet_tpu.detect.net import space_to_depth as jax_s2d
from synergynet_tpu.detect.nms import greedy_nms_mask as jax_nms
from synergynet_tpu.detect.torch_import import random_init_variables
from synergynet_tpu.pipeline import FusedFrameEngine as JaxEngine
from synergynet_tpu.pipeline import SynergyNet3DMM as JaxApi
from synergynet_tpu.pipeline.api import prepare_frame as jax_prepare_frame
from synergynet_tpu.pipeline.device_crop import square_rois as jax_square
from synergynet_tpu_torch.detect.detector import (
    BGR_MEAN, CANVAS, CONFIDENCE_THRESHOLD, NMS_THRESHOLD, NMS_TOP_K,
    VIS_THRESHOLD, FaceBoxes)
from synergynet_tpu_torch.detect.net import space_to_depth
from synergynet_tpu_torch.pipeline import (FusedFrameEngine, SynergyNet3DMM,
                                           prepare_frame, square_rois)

torch.set_num_threads(2)

F_MAX = 8
LMK = dict(rtol=1e-5, atol=1e-4)
DENSE = dict(rtol=1e-4, atol=1e-3)
CHAIN = dict(rtol=1e-4, atol=1e-2)


@pytest.fixture(scope="module")
def engines():
    jdet = JaxFaceBoxes(variables=random_init_variables())
    japi = JaxApi(variables="trained", detector=jdet)
    jeng = JaxEngine(japi, detector=jdet, max_faces=F_MAX)
    tdet = FaceBoxes(variables=jax.device_get(jdet.variables), device="cpu")
    tapi = SynergyNet3DMM(variables="trained", device="cpu")
    teng = FusedFrameEngine(tapi, detector=tdet, max_faces=F_MAX)
    return jeng, teng


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(5).integers(0, 256, (720, 1088, 3),
                                             np.uint8)


@pytest.fixture(scope="module")
def jax_frame_out(engines, frame):
    """The JAX engine's one-frame program on the JAX-prepared canvas."""
    jeng, _ = engines
    canvas, packed, true_hw, _ = jax_prepare_frame(frame, 8)
    out = jeng._program(jeng.api.variables, jeng.detector.variables,
                        *jeng.pack_args, jnp.asarray(canvas),
                        jnp.asarray(packed), true_hw)
    return canvas, packed, np.asarray(true_hw), [np.asarray(o) for o in out]


def _jax_candidates(jeng, packed, true_hw):
    """api.py:288-298 on the JAX side: logits, masked scores, boxes."""
    ch, cw = CANVAS
    det = jeng.detector
    mean = jnp.asarray(np.tile(BGR_MEAN, 64), jnp.float32)

    @jax.jit
    def run(det_vars, anchors, x, hw):
        loc, conf = det.net.apply(det_vars, (x - mean)[None], train=False)
        scores = jax.nn.softmax(conf[0], axis=-1)[:, 1]
        boxes = jax_decode_boxes(loc[0], anchors) * jnp.asarray(
            [cw, ch, cw, ch], jnp.float32)
        cx = (boxes[:, 0] + boxes[:, 2]) / 2
        cy = (boxes[:, 1] + boxes[:, 3]) / 2
        ok = ((cx < hw[1].astype(jnp.float32))
              & (cy < hw[0].astype(jnp.float32))
              & (scores > CONFIDENCE_THRESHOLD))
        return loc[0], conf[0], jnp.where(ok, scores, -1.0), boxes

    return [np.asarray(o) for o in run(det.variables, det.anchors,
                                       jnp.asarray(packed),
                                       jnp.asarray(true_hw))]


@jax.jit
def _jax_select(scores, boxes):
    """api.py:299-309 on the JAX side."""
    top_scores, idx = jax.lax.top_k(scores, NMS_TOP_K)
    top_boxes = boxes[idx]
    keep = jax_nms(top_boxes, top_scores > 0.0, NMS_THRESHOLD)
    keep &= top_scores > VIS_THRESHOLD
    order = jnp.argsort(~keep, stable=True)[:F_MAX]
    face_scores = jnp.where(keep[order], top_scores[order], -1.0)
    return (face_scores, jnp.sum(face_scores > 0),
            jax_square(top_boxes[order]))


@pytest.mark.parametrize("hw", [(720, 1088), (480, 640)])
def test_prepare_frame_matches(hw):
    img = np.random.default_rng(6).integers(0, 256, (*hw, 3), np.uint8)
    jc, jp, jhw, js = jax_prepare_frame(img, 8)
    tc, tp, thw, ts = prepare_frame(img, 8, device="cpu")
    assert ts == js and np.array_equal(thw.numpy(), np.asarray(jhw))
    diff = np.abs(tc.numpy() - jc)
    if js == 1.0:
        assert diff.max() == 0.0
    else:   # cv2 rounds fixed-point sums: one level off (13% of this noise)
        assert diff.max() <= 1.0
    assert np.array_equal(tp.numpy(), jax_s2d(tc.numpy(), 8))


def test_stage1_detector(engines, jax_frame_out):
    jeng, teng = engines
    _, packed, true_hw, _ = jax_frame_out
    jloc, jconf, jscores, jboxes = _jax_candidates(jeng, packed, true_hw)
    x = torch.tensor(packed)[None]
    with torch.no_grad():
        loc, conf = teng.detector.net(x - teng._det_mean)
        scores, boxes = teng.detect_candidates(
            x, torch.tensor(true_hw)[None])
    np.testing.assert_allclose(loc[0].numpy(), jloc, rtol=0, atol=1e-4)
    np.testing.assert_allclose(conf[0].numpy(), jconf, rtol=0, atol=1e-4)
    np.testing.assert_allclose(scores[0].numpy(), jscores, rtol=0, atol=1e-4)
    # exp(0.2 * loc) carries the logits' error into relative box error.
    np.testing.assert_allclose(boxes[0].numpy(), jboxes, rtol=1e-4, atol=0.05)


def _sparse_candidates(rng, a):
    """Mostly -1 sentinels (ties), 5 visible faces: padding rows must come
    from the tied sentinels in index order."""
    scores = np.full(a, -1.0, np.float32)
    scores[rng.choice(a, 300, replace=False)] = rng.uniform(0.06, 0.45, 300)
    scores[rng.choice(a, 5, replace=False)] = rng.uniform(0.6, 0.99, 5)
    xy = rng.uniform(0, 900, (a, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(20, 200, (a, 2))], 1)
    return scores.astype(np.float32), boxes.astype(np.float32)


@pytest.mark.parametrize("source", ["frame", "sparse"])
def test_stage2_selection_exact(source, engines, jax_frame_out, rng):
    jeng, teng = engines
    if source == "frame":
        _, packed, true_hw, _ = jax_frame_out
        _, _, scores, boxes = _jax_candidates(jeng, packed, true_hw)
    else:
        scores, boxes = _sparse_candidates(rng, 16680)
    want = [np.asarray(o) for o in _jax_select(jnp.asarray(scores),
                                               jnp.asarray(boxes))]
    fs, n, fb = teng.select_faces(torch.tensor(scores)[None],
                                  torch.tensor(boxes)[None])
    assert np.array_equal(fs[0].numpy(), want[0])
    assert int(n[0]) == int(want[1])
    assert np.array_equal(square_rois(fb)[0].numpy(), want[2])
    if source == "sparse":
        assert int(n[0]) == 5 and np.all(fs[0, 5:].numpy() == -1.0)


def test_stage3_regress_and_decode(engines, jax_frame_out):
    jeng, teng = engines
    canvas, _, _, out = jax_frame_out
    _, _, rois, p62, lmk, dense, angles, t3d = out
    rois_t = torch.tensor(rois)
    with torch.no_grad():
        param62 = teng.regress(torch.tensor(canvas)[None],
                               rois_t[None])[0]
    np.testing.assert_allclose(param62.numpy(), p62, rtol=0, atol=1e-4)
    for params, tol, dtol in ((torch.tensor(p62), LMK, DENSE),
                              (param62, CHAIN, CHAIN)):
        tl, td, ta, tt = teng.tail(params, rois_t)
        np.testing.assert_allclose(tl.numpy(), lmk, **tol)
        np.testing.assert_allclose(td.numpy(), dense, **dtol)
        np.testing.assert_allclose(ta.numpy(), angles, **tol)
        np.testing.assert_allclose(tt.numpy(), t3d, **tol)
    assert td.shape == (F_MAX, 3, 53215) and tl.shape == (F_MAX, 3, 68)


def test_call_matches_jax(engines):
    """End to end through __call__ on a frame that needs no resize, so both
    sides see the same canvas."""
    jeng, teng = engines
    img = np.random.default_rng(8).integers(0, 256, (480, 640, 3), np.uint8)
    jp, jv, jpose = jeng(img)
    tp, tv, tpose = teng(img)
    assert len(tp) == len(jp) > 0
    for i in range(len(jp)):
        np.testing.assert_allclose(tp[i], jp[i], **CHAIN)
        np.testing.assert_allclose(tv[i], jv[i], **CHAIN)
        np.testing.assert_allclose(tpose[i][0], jpose[i][0], **CHAIN)
        np.testing.assert_allclose(tpose[i][1], jpose[i][1], **CHAIN)


def test_process_batch_b2(engines):
    """B=2 frames: the port's batch equals its one-frame runs, and matches
    the JAX batch program."""
    jeng, teng = engines
    rng = np.random.default_rng(9)
    ch, cw = CANVAS
    frames = rng.integers(0, 256, (2, ch, cw, 3)).astype(np.float32)
    packed = space_to_depth(torch.tensor(frames), 8).contiguous().numpy()
    hws = np.asarray([[ch, cw], [600, 900]], np.int32)
    got = teng.process_batch(torch.tensor(frames),
                             torch.tensor(packed), torch.tensor(hws))
    want = [np.asarray(o) for o in jeng.process_batch(
        jnp.asarray(frames), jnp.asarray(packed), jnp.asarray(hws))]
    shapes = [(2, F_MAX), (2,), (2, F_MAX, 4), (2, F_MAX, 62),
              (2, F_MAX, 3, 68), (2, F_MAX, 3, 53215), (2, F_MAX, 3),
              (2, F_MAX, 3)]
    assert [tuple(g.shape) for g in got] == shapes
    for b in range(2):
        one = teng.process_batch(torch.tensor(frames[b:b + 1]),
                                 torch.tensor(packed[b:b + 1]),
                                 torch.tensor(hws[b:b + 1]))
        for g, o in zip(got, one):
            np.testing.assert_allclose(g[b].numpy(), o[0].numpy(),
                                       rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=0, atol=1e-4)
    for i in (4, 5, 6, 7):
        np.testing.assert_allclose(got[i].numpy(), want[i], **CHAIN)


def _oversized(hw, kind):
    if kind == "noise":
        return np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3),
                                                      np.uint8)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    return np.stack([127 + 120 * np.sin(xx / 37.0 + c) * np.cos(yy / 23.0)
                     for c in range(3)], -1).astype(np.uint8)


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("hw", [(1080, 1920), (1440, 2560), (800, 1000),
                                (721, 1081)])
def test_prepare_frame_matches_cv2_on_oversized_frames(hw, kind):
    """Frames that scale down: the canvas equals the JAX package's
    (``cv2.resize``, INTER_LINEAR's fixed point) bit for bit, and the
    overlay's scale back to the frame's size equals ``cv2.resize``'s."""
    import cv2
    from synergynet_tpu_torch.ops.resize import _resize_linear
    img = _oversized(hw, kind)
    jc, jp, jhw, js = jax_prepare_frame(img, 8)
    tc, tp, thw, ts = prepare_frame(img, 8, device="cpu")
    assert ts == js < 1.0 and np.array_equal(thw.numpy(), np.asarray(jhw))
    assert np.array_equal(tc.numpy(), jc)
    hs, ws = thw.tolist()
    small = tc.numpy()[:hs, :ws].astype(np.uint8)
    back = _resize_linear(torch.from_numpy(small), *hw)
    assert np.array_equal(back.numpy().astype(np.uint8),
                          cv2.resize(small, (hw[1], hw[0])))
