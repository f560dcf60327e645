"""The port's overlay path against the JAX package's FusedOverlayEngine.

1. ``render_lit_faces`` and ``render_lit_faces_adaptive`` at toy size, for
   every face count: pixels undrawn in both are exact, the rest within one
   uint8 step on >= 99.5% of pixels (a knife-edge pixel flips where XLA's
   FMA contraction moves a plane value across a coverage edge).
2. The render stage at full width (8 faces x 105,840 triangles on the
   720x1088 canvas), fed the JAX engine's own dense meshes: at most 0.5% of
   drawn pixels differ by more than one step. The synthetic BFM mesh's
   front and back surfaces nearly tie in depth, so a last-bit difference in
   the light or the planes can flip a pixel by many steps.
3. ``FusedOverlayEngine.__call__`` on a 480x640 noise frame: landmarks,
   meshes and poses at CHAIN (test_torch_pipeline.py: the port's own
   param62, <= 1e-4 off, chained through the decode), and >= 99% of the
   overlay's pixels within two steps: the chained 1e-2 px error moves
   silhouette pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu.detect.detector import FaceBoxes as JaxFaceBoxes
from synergynet_tpu.detect.torch_import import random_init_variables
from synergynet_tpu.pipeline import FusedFrameEngine as JaxEngine
from synergynet_tpu.pipeline import SynergyNet3DMM as JaxApi
from synergynet_tpu.pipeline.api import prepare_frame as jax_prepare_frame
from synergynet_tpu.pipeline.overlay_engine import \
    FusedOverlayEngine as JaxOverlay
from synergynet_tpu.pipeline.overlay_engine import \
    render_lit_faces as jax_render
from synergynet_tpu.pipeline.overlay_engine import \
    render_lit_faces_adaptive as jax_render_adaptive
from synergynet_tpu_torch.detect import FaceBoxes
from synergynet_tpu_torch.pipeline import (FusedFrameEngine,
                                           FusedOverlayEngine,
                                           SynergyNet3DMM, render_lit_faces,
                                           render_lit_faces_adaptive)
from synergynet_tpu_torch.render import one_ring_table

torch.set_num_threads(2)

F_MAX = 8
CHAIN = dict(rtol=1e-4, atol=1e-2)


def _undrawn(solid, frame):
    return (solid == frame).all(-1)


def _toy(seed=5, nver=25, f=4):
    rng = np.random.default_rng(seed)
    base = np.stack([rng.uniform(4, 28, nver), rng.uniform(4, 28, nver),
                     rng.uniform(1, 6, nver)], 1).astype(np.float32)
    tris = rng.integers(0, nver, (30, 3)).astype(np.int32)
    verts = np.stack([base + np.asarray([30 * i, 2 * i, 0], np.float32)
                      for i in range(f)])
    tris_all = (tris[None] + (np.arange(f) * nver)[:, None, None]
                ).reshape(-1, 3).astype(np.int32)
    frame = rng.integers(0, 120, (32, 128, 3)).astype(np.uint8)
    return frame, verts, tris, tris_all


@pytest.mark.parametrize("n", range(5))
def test_render_lit_faces_matches_jax(n):
    frame, verts, tris, tris_all = _toy()
    f, nver = verts.shape[:2]
    rings = one_ring_table(tris, nver)
    jr = jnp.asarray(rings.numpy())
    jargs = (jnp.asarray(frame), jnp.asarray(verts))
    jtopo = (jnp.asarray(tris), jnp.asarray(tris_all), jr)
    targs = (torch.from_numpy(frame), torch.from_numpy(verts))
    ttopo = (torch.from_numpy(tris).long(), torch.from_numpy(tris_all).long(),
             rings.long())
    kw = dict(alpha=0.6, replication=(8, 2), interpret=True)

    results = []
    want = jax_render_adaptive(*jargs, jnp.int32(n), *jtopo, **kw)
    got = render_lit_faces_adaptive(*targs, n, *ttopo, alpha=0.6)
    results.append((want, got))
    if n:
        valid = np.arange(f) < n
        want = jax_render(*jargs, jnp.asarray(valid), *jtopo, **kw)
        got = render_lit_faces(*targs, torch.from_numpy(valid), *ttopo,
                               alpha=0.6)
        results.append((want, got))
    for (jov, jso), (tov, tso) in results:
        jov, jso = np.asarray(jov), np.asarray(jso)
        tov, tso = tov.numpy(), tso.numpy()
        assert tov.dtype == np.uint8 and tov.shape == frame.shape
        blank = _undrawn(jso, frame) & _undrawn(tso, frame)
        np.testing.assert_array_equal(tov[blank], jov[blank])
        np.testing.assert_array_equal(tov[blank], frame[blank])
        for a, b in ((tov, jov), (tso, jso)):
            step = np.abs(a.astype(int) - b.astype(int)).max(-1)
            assert (step <= 1).mean() >= 0.995
        if n == 0:
            np.testing.assert_array_equal(tov, frame)
        else:
            assert (~blank).any()


@pytest.fixture(scope="module")
def engines():
    jdet = JaxFaceBoxes(variables=random_init_variables())
    japi = JaxApi(variables="trained", detector=jdet)
    jov = JaxOverlay(JaxEngine(japi, detector=jdet, max_faces=F_MAX))
    tdet = FaceBoxes(variables=jax.device_get(jdet.variables), device="cpu")
    tapi = SynergyNet3DMM(variables="trained", device="cpu")
    tov = FusedOverlayEngine(FusedFrameEngine(tapi, detector=tdet,
                                              max_faces=F_MAX))
    return jov, tov


def test_render_stage_full_width(engines):
    jov, tov = engines
    frame = np.random.default_rng(5).integers(0, 256, (720, 1088, 3),
                                              np.uint8)
    canvas, packed, true_hw, _ = jax_prepare_frame(frame, 8)
    je = jov.engine
    outs, joverlay, jsolid = jov._program(
        je.api.variables, je.detector.variables, *je.pack_args,
        jov._tris_face, jov._tris_all, jov._rings, jnp.asarray(canvas),
        jnp.asarray(packed), true_hw)
    n = int(outs[1])
    dense = np.asarray(outs[5])
    assert n == F_MAX and dense.shape == (F_MAX, 3, 53215)
    frame_u8 = np.clip(canvas, 0, 255).astype(np.uint8)
    with torch.inference_mode():
        tovl, tsolid = tov.render(torch.from_numpy(frame_u8),
                                  torch.from_numpy(dense.copy()), n)
    jovl, jsolid = np.asarray(joverlay), np.asarray(jsolid)
    tovl, tsolid = tovl.numpy(), tsolid.numpy()
    drawn = ~(_undrawn(jsolid, frame_u8) & _undrawn(tsolid, frame_u8))
    assert drawn.mean() > 0.05
    np.testing.assert_array_equal(tovl[~drawn], jovl[~drawn])
    step = np.abs(tovl.astype(int) - jovl.astype(int)).max(-1)
    assert (step[drawn] > 1).mean() <= 0.005


def test_call_matches_jax(engines):
    jov, tov = engines
    img = np.random.default_rng(11).integers(0, 256, (480, 640, 3),
                                             np.uint8)
    jpts, jverts, jposes, jovl = jov(img)
    tpts, tverts, tposes, tovl = tov(img)
    assert len(tpts) == len(jpts) > 0
    for a, b in zip(tpts, jpts):
        np.testing.assert_allclose(a, b, **CHAIN)
    for a, b in zip(tverts, jverts):
        np.testing.assert_allclose(a, b, **CHAIN)
    for (ta, tt), (ja, jt) in zip(tposes, jposes):
        np.testing.assert_allclose(ta, ja, **CHAIN)
        np.testing.assert_allclose(tt, jt, **CHAIN)
    assert tovl.shape == img.shape and tovl.dtype == np.uint8
    step = np.abs(tovl.astype(int) - np.asarray(jovl).astype(int)).max(-1)
    assert (step <= 2).mean() >= 0.99
    assert (tovl != img).any()


def test_call_oversized_frame_keeps_its_shape(engines):
    _, tov = engines
    img = np.random.default_rng(12).integers(0, 256, (1080, 1920, 3),
                                             np.uint8)
    pts, verts, poses, ovl = tov(img)
    assert ovl.shape == img.shape and ovl.dtype == np.uint8
    assert len(pts) == len(verts) == len(poses) > 0
    assert all(v.shape == (3, 53215) and np.isfinite(v).all() for v in verts)
    assert (ovl != img).any()
