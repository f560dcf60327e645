"""The port's drawing helpers and demo apps against the JAX package's, on
the CPU.

- ``draw_landmarks`` (the saved PNGs decode to equal arrays),
  ``draw_axis`` and ``viz_bbox`` (equal arrays) on the same inputs, numpy
  and CPU tensors; ``LANDMARK_GROUPS`` and ``CLOSE_PAIRS`` equal.
- ``infer.run``, ``artistic.run`` and ``uv_texture.run`` with the shipped
  weights. ``infer`` and ``artistic`` take their faces from each package's
  default detector on a seeded 24x32 jpg (11 faces, every candidate score
  of the decoded jpg at least 0.14 from the 0.5 threshold); the one face
  whose square roi misses the frame, on which the JAX package's crop
  raises (its fault C7/C8, not copied by the port), is dropped from both
  by the same rule.
  ``uv_texture`` takes a seeded 256x256 jpg. The face counts are equal;
  poses and the ``.obj`` vertices within ``test_torch_api.py``'s CHAIN
  (rtol 1e-4 / atol 1e-2), the ``.obj`` faces and colors equal; the
  overlays (and solid layers) that the apps write, read before the jpg
  encoder, within the bounds of ``test_torch_host_render.py``'s
  ``render_overlay`` test; the same files under ``out_dir``.
- ``infer.main`` with ``--checkpoint trained --platform cpu`` on the
  port's default detector alone, and the checkpoint forms it takes.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from synergynet_tpu.cli import artistic as jax_artistic
from synergynet_tpu.cli import infer as jax_infer
from synergynet_tpu.cli import uv_texture as jax_uv
from synergynet_tpu.detect import FaceBoxes as JaxFaceBoxes
from synergynet_tpu.mm3d.crop import crop_img as jax_crop_img
from synergynet_tpu.mm3d.crop import square_box as jax_square_box
from synergynet_tpu.pipeline import SynergyNet3DMM as JaxApi
from synergynet_tpu.pipeline import draw as jdraw
from synergynet_tpu_torch.cli import artistic, infer, uv_texture
from synergynet_tpu_torch.detect import FaceBoxes
from synergynet_tpu_torch.pipeline import SynergyNet3DMM
from synergynet_tpu_torch.pipeline import draw

torch.set_num_threads(2)

CHAIN = dict(rtol=1e-4, atol=1e-2)      # test_torch_api.py's
FRAME_HW, FRAME_SEED = (24, 32), 1
N_FACES = 10                            # of the detector's 11


def _frame(hw, seed):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)


# -- drawing ------------------------------------------------------------------

def _lmk(seed, n=68, scale=100.0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(10, scale, n), rng.uniform(10, scale, n),
                     rng.normal(0, 5, n)]).astype(np.float32)


def test_draw_constants_match():
    assert draw.LANDMARK_GROUPS == jdraw.LANDMARK_GROUPS
    assert draw.CLOSE_PAIRS == jdraw.CLOSE_PAIRS


@pytest.mark.parametrize("as_tensor", [False, True])
def test_draw_landmarks_matches(tmp_path, as_tensor):
    img = _frame((90, 120), 1)
    pts = [_lmk(2), _lmk(3)]
    jdraw.draw_landmarks(img, pts, str(tmp_path / "jax.png"), dpi=50)
    arg_img = torch.from_numpy(img) if as_tensor else img
    arg_pts = [torch.from_numpy(p) for p in pts] if as_tensor else pts
    assert draw.draw_landmarks(arg_img, arg_pts, str(tmp_path / "port.png"),
                               dpi=50) is None
    a = cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED)
    b = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    assert a.shape == b.shape and np.array_equal(a, b)
    fig = draw.draw_landmarks(img, pts[0])          # one set, a figure back
    import matplotlib.pyplot as plt
    assert fig is not None
    plt.close(fig)


@pytest.mark.parametrize("angles", [(10.0, -20.0, 5.0), (-70.5, 33.25, 170.0),
                                    (0.0, 0.0, 0.0)])
def test_draw_axis_matches(angles):
    img = _frame((120, 140), 4)
    pts = _lmk(5)
    yaw, pitch, roll = (np.float32(a) for a in angles)
    want = jdraw.draw_axis(img.copy(), yaw, pitch, roll, pts)
    got = img.copy()
    out = draw.draw_axis(got, yaw, pitch, roll, pts)
    assert out is got and np.array_equal(got, want)      # in place
    t = torch.from_numpy(img.copy())
    draw.draw_axis(t, torch.tensor(yaw), torch.tensor(pitch),
                   torch.tensor(roll), torch.from_numpy(pts), thickness=4)
    assert np.array_equal(t.numpy(), want)


def test_viz_bbox_matches():
    img = _frame((120, 160), 6)
    dets = [[10.2, 20.7, 80.1, 90.9, 0.97], [50, 5, 150, 100, 0.3],
            [-5.5, 60.0, 40.0, 130.0, 0.51]]
    want = jdraw.viz_bbox(img.copy(), dets)
    got = draw.viz_bbox(img.copy(), dets)
    assert np.array_equal(got, want)
    t = torch.from_numpy(img.copy())
    draw.viz_bbox(t, dets, vis_thresh=0.5)
    assert np.array_equal(t.numpy(), want)


# -- the apps -----------------------------------------------------------------

class Croppable:
    """A package's detector, keeping the faces whose square roi the JAX
    package's ``crop_img`` can crop from the frame."""

    def __init__(self, det):
        self.det = det

    def __call__(self, img):
        keep = []
        for r in self.det(img):
            try:
                jax_crop_img(img, jax_square_box(r))
            except ValueError:
                continue
            keep.append(r)
        return keep


@pytest.fixture(scope="module")
def apis():
    return (JaxApi(variables="trained", detector=Croppable(JaxFaceBoxes())),
            SynergyNet3DMM(variables="trained", device="cpu",
                           detector=Croppable(FaceBoxes(device="cpu"))))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    base = tmp_path_factory.mktemp("apps")
    faces, real, tex = base / "faces", base / "real", base / "tex"
    for d in (faces, real, tex):
        d.mkdir()
    cv2.imwrite(str(faces / "face.jpg"), _frame(FRAME_HW, FRAME_SEED))
    cv2.imwrite(str(real / "real.jpg"), _frame((256, 256), 7))
    texture = _frame((256, 256), 8)
    cv2.imwrite(str(tex / "face_fake_B.png"), texture)
    cv2.imwrite(str(tex / "real_fake_B.png"), texture[::-1])
    return {"faces": str(faces), "real": str(real), "tex": str(tex)}


@pytest.fixture()
def written(monkeypatch):
    """Every image an app hands to ``cv2.imwrite``, by path, before the
    encoder."""
    seen = {}
    real = cv2.imwrite

    def imwrite(path, img, *a):
        seen[os.path.abspath(path)] = np.array(img)
        return real(path, img, *a)
    monkeypatch.setattr(cv2, "imwrite", imwrite)
    return seen


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _read_obj(path):
    v, rest = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                v.append([float(x) for x in line.split()[1:]])
            else:
                rest.append(line)
    return np.asarray(v), rest


def _assert_overlay_close(got, want):
    """test_torch_host_render.py's render_overlay bounds."""
    diff = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02


def _assert_solid_close(got, want, bg):
    """test_torch_host_render.py's _assert_image_close."""
    drawn_g, drawn_w = (got != bg).any(-1), (want != bg).any(-1)
    assert (drawn_g == drawn_w).mean() >= 0.995
    both_undrawn = ~drawn_g & ~drawn_w
    assert np.array_equal(got[both_undrawn], want[both_undrawn])
    diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert (diff <= 1).mean() >= 0.995


def test_infer_run_matches(apis, inputs, tmp_path, written):
    japi, tapi = apis
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_infer.run(inputs["faces"], out_dir=jout, api=japi)
    got = infer.run(inputs["faces"], out_dir=tout, api=tapi)
    assert sorted(got) == sorted(want) == ["face"]
    assert got["face"]["faces"] == want["face"]["faces"] == N_FACES
    for (ga, gt), (wa, wt) in zip(got["face"]["poses"],
                                  want["face"]["poses"]):
        np.testing.assert_allclose(ga, np.asarray(wa), **CHAIN)
        np.testing.assert_allclose(gt, np.asarray(wt), **CHAIN)
    assert _files(tout) == _files(jout) == [
        "landmarks/face.jpg", "obj/face.obj", "poses/face.jpg",
        "rendering_overlay/face.jpg", "rendering_overlay/face_solid.png"]
    gv, grest = _read_obj(os.path.join(tout, "obj", "face.obj"))
    wv, wrest = _read_obj(os.path.join(jout, "obj", "face.obj"))
    assert gv.shape == wv.shape == (53215, 3) and grest == wrest
    np.testing.assert_allclose(gv, wv, **CHAIN)
    img = cv2.imread(os.path.join(inputs["faces"], "face.jpg"))
    ov = "rendering_overlay/face.jpg"
    solid = "rendering_overlay/face_solid.png"
    _assert_overlay_close(written[os.path.join(tout, ov)],
                          written[os.path.join(jout, ov)])
    _assert_solid_close(written[os.path.join(tout, solid)],
                        written[os.path.join(jout, solid)], img)


def test_artistic_run_matches(apis, inputs, tmp_path):
    japi, tapi = apis
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    for uv_dir in (inputs["tex"], str(tmp_path / "none")):   # flat tone too
        want = jax_artistic.run(inputs["faces"], uv_dir=uv_dir, out_dir=jout,
                                api=japi)
        got = artistic.run(inputs["faces"], uv_dir=uv_dir, out_dir=tout,
                           api=tapi)
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in want] == ["face.obj"]
        gv, grest = _read_obj(got[0])
        wv, wrest = _read_obj(want[0])
        assert gv.shape == wv.shape and gv.shape[1] == 6 and grest == wrest
        np.testing.assert_allclose(gv[:, :3], wv[:, :3], **CHAIN)
        assert np.array_equal(gv[:, 3:], wv[:, 3:])          # colors
    assert _files(tout) == _files(jout)


def test_uv_texture_run_matches(apis, inputs, tmp_path, written):
    japi, tapi = apis
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_uv.run(inputs["real"], tex_dir=inputs["tex"], out_dir=jout,
                      api=japi)
    got = uv_texture.run(inputs["real"], tex_dir=inputs["tex"], out_dir=tout,
                         api=tapi)
    assert [os.path.relpath(p, tout) for p in got] == \
        [os.path.relpath(p, jout) for p in want] == ["obj/real.obj"]
    gv, grest = _read_obj(got[0])
    wv, wrest = _read_obj(want[0])
    assert gv.shape == wv.shape and grest == wrest
    np.testing.assert_allclose(gv[:, :3], wv[:, :3], **CHAIN)
    assert np.array_equal(gv[:, 3:], wv[:, 3:])
    assert _files(tout) == _files(jout) == [
        "obj/real.obj", "rendering_overlay/real.jpg"]
    ov = "rendering_overlay/real.jpg"
    _assert_overlay_close(written[os.path.join(tout, ov)],
                          written[os.path.join(jout, ov)])


def test_infer_main_on_the_default_detector(inputs, tmp_path):
    """The port alone, as a user runs it: the shipped weights and the
    default detector, every face it keeps (crops that miss the frame are
    zero in the port)."""
    img = cv2.imread(os.path.join(inputs["faces"], "face.jpg"))
    n = len(FaceBoxes(device="cpu")(img))
    assert n == N_FACES + 1
    out = str(tmp_path / "out")
    r = infer.main(["-f", os.path.join(inputs["faces"], "face.jpg"),
                    "--out-dir", out, "--checkpoint", "trained",
                    "--platform", "cpu"])
    assert r["face"]["faces"] == n
    assert all(np.isfinite(a).all() and np.isfinite(t).all()
               for a, t in r["face"]["poses"])
    assert _files(out) == [
        "landmarks/face.jpg", "obj/face.obj", "poses/face.jpg",
        "rendering_overlay/face.jpg", "rendering_overlay/face_solid.png"]


def test_infer_checkpoint_forms(tmp_path):
    from synergynet_tpu_torch.core.checkpoint import (load_shipped_trained,
                                                      shipped_trained_path)
    from synergynet_tpu_torch.nn.torch_import import (
        expected_torch_shapes, load_synergynet_variables,
        seeded_torch_state_dict)
    assert infer.load_variables(None) is None
    assert infer.load_variables("trained") == "trained"

    def leaves(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, prefix + (k,)) if isinstance(v, dict)
                       else {"/".join(prefix + (k,)): v})
        return out

    got = leaves(infer.load_variables(shipped_trained_path()))
    want = leaves(load_shipped_trained())
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in got)
    sd = seeded_torch_state_dict(expected_torch_shapes("mobilenet_v2"), 3)
    path = str(tmp_path / "best.pth.tar")
    torch.save({"state_dict": sd}, path)
    got = leaves(infer.load_variables(path))
    want = leaves(load_synergynet_variables(path))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in got)
    SynergyNet3DMM(variables=infer.load_variables(path), device="cpu")
