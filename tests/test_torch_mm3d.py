"""Parity of the port's 3DMM core (synergynet_tpu_torch.mm3d) with the JAX
package: the synthetic pack byte for byte, the codec and the pose math in
f32 at rtol 1e-5 / atol 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synergynet_tpu import mm3d as jm
from synergynet_tpu_torch import mm3d as tm
from synergynet_tpu_torch.mm3d.assets import pack_from_arrays

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-4


def to_torch_pack(pack):
    """The JAX package's numpy pack as the port's tensor pack."""
    return tm.ParamPack(*(torch.from_numpy(np.asarray(x)) for x in pack))


@pytest.fixture(scope="module")
def tpack(pack):
    return to_torch_pack(pack)


@pytest.fixture(scope="module")
def small_tpack(small_pack):
    return to_torch_pack(small_pack)


def test_synthetic_pack_byte_identical():
    want = jm.make_synthetic_assets(seed=0)
    got = tm.make_synthetic_assets(seed=0)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_pack_from_arrays_and_cached_pack_match(pack):
    """The port's cached pack (same assets/bfm_synth.npz rule) and its
    pack_from_arrays equal the JAX pack leaf by leaf."""
    got = tm.load_param_pack()
    for name, a, b in zip(jm.ParamPack._fields, pack, got):
        assert b.numpy().dtype == np.asarray(a).dtype, name
        assert np.array_equal(b.numpy(), np.asarray(a)), name
    rng = np.random.default_rng(3)
    d = {"u_shp": rng.normal(0, 1, (30, 1)), "u_exp": rng.normal(0, 1, (30, 1)),
         "w_shp": rng.normal(0, 1, (30, 40)), "w_exp": rng.normal(0, 1, (30, 10)),
         "keypoints": np.arange(6), "param_mean": rng.normal(0, 1, 64),
         "param_std": rng.uniform(1, 2, 64), "tri": np.zeros((3, 4), np.int64)}
    for a, b in zip(jm.pack_from_arrays(d), pack_from_arrays(d)):
        assert np.array_equal(b.numpy(), np.asarray(a))


def _params(rng, b, scale):
    return rng.normal(0, scale, (b, 62)).astype(np.float32)


@pytest.mark.parametrize("which", ["small", "full"])
@pytest.mark.parametrize("fn", ["decode_landmarks", "decode_dense"])
def test_decode_matches_jax(which, fn, request, rng):
    jpack = request.getfixturevalue("small_pack" if which == "small"
                                    else "pack")
    tp = request.getfixturevalue("small_tpack" if which == "small"
                                 else "tpack")
    p = _params(rng, 5, 1.0 if which == "small" else 0.5)
    want = np.asarray(getattr(jm, fn)(jnp.asarray(p), jpack))
    got = getattr(tm, fn)(torch.from_numpy(p), tp).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["small", "full"])
def test_pose_and_rescales_match_jax(which, request, rng):
    jpack = request.getfixturevalue("small_pack" if which == "small"
                                    else "pack")
    tp = request.getfixturevalue("small_tpack" if which == "small"
                                 else "tpack")
    p = _params(rng, 6, 0.5)
    rois = np.concatenate([rng.uniform(0, 300, (6, 2)),
                           rng.uniform(320, 700, (6, 2))],
                          1).astype(np.float32)
    ja, jt = jm.pose_from_param(jnp.asarray(p), jpack)
    ta, tt = tm.pose_from_param(torch.from_numpy(p), tp)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        tm.rescale_pose_to_roi(tt, torch.from_numpy(rois)).numpy(),
        np.asarray(jm.rescale_pose_to_roi(jt, jnp.asarray(rois))),
        rtol=RTOL, atol=ATOL)
    verts = rng.normal(60, 20, (6, 3, 97)).astype(np.float32)
    np.testing.assert_allclose(
        tm.rescale_to_roi(torch.from_numpy(verts),
                          torch.from_numpy(rois)).numpy(),
        np.asarray(jm.rescale_to_roi(jnp.asarray(verts), jnp.asarray(rois))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_euler_gimbal_lock_matches_jax(sign, rng):
    """R20 = +-1 takes the locked branch (z := 0) on both sides."""
    a = rng.uniform(-np.pi, np.pi, 3)
    R = np.zeros((3, 3, 3), np.float32)
    for i, t in enumerate(a):
        c, s = np.cos(t), np.sin(t)
        R[i] = [[0, s, -sign * c], [0, c, sign * s], [sign, 0, 0]]
    want = np.asarray(jm.matrix_to_euler_deg(jnp.asarray(R)))
    got = tm.matrix_to_euler_deg(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(got[:, 2] == 0.0)
    np.testing.assert_allclose(got[:, 0], -sign * 90.0, atol=ATOL)


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_pose_from_param_gimbal_lock_matches_jax(sign, small_pack,
                                                 small_tpack):
    """A camera matrix 2R | t with R20 = +-1 exactly: identity whitening
    keeps it exact, so both sides take the locked branch."""
    P = []
    for s, c in ((0.0, 1.0), (1.0, 0.0)):
        R = np.array([[0, s, -sign * c], [0, c, sign * s], [sign, 0, 0]])
        P.append(np.concatenate([2.0 * R, [[5.0], [-3.0], [7.0]]], 1))
    raw = np.zeros((2, 62), np.float32)
    raw[:, :12] = np.reshape(P, (2, 12))
    ident = dict(param_mean=np.zeros(62, np.float32),
                 param_std=np.ones(62, np.float32))
    ja, jt = jm.pose_from_param(jnp.asarray(raw),
                                small_pack._replace(**ident))
    ta, tt = tm.pose_from_param(torch.from_numpy(raw), small_tpack._replace(
        **{k: torch.from_numpy(v) for k, v in ident.items()}))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL,
                               atol=ATOL)
    assert np.all(ta.numpy()[:, 2] == 0.0)


def test_p2srt_matches_jax(rng):
    P = rng.normal(0, 1, (7, 3, 4)).astype(np.float32)
    for g, w in zip(tm.p2srt(torch.from_numpy(P)),
                    jm.p2srt(jnp.asarray(P))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
