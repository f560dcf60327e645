"""The port's 3DMM asset converters against the JAX package's, on the CPU.

Seeded trees are written into ``tmp_path`` at a small size (300 vertices,
68 keypoints, 500 triangles; the bases carry extra columns that the raw
converter must trim) in the reference's layouts:

- ``3dmm_data/`` (npy bases, the whitening pickle, a 1-based ``tri.mat``
  or none) through ``convert_reference_assets``;
- a raw Basel Face Model ``.mat`` in the ``model_refine`` layout (1-based
  keypoints and triangles, 60 shape and 29 expression columns), with and
  without its own ``tri``, a separate ``tri.mat`` and the whitening
  pickle, through ``convert_raw_bfm``.

The dicts equal key for key, bit for bit, dtypes included; each result
written by ``save_assets_npz`` and named by ``$SYNERGY_BFM`` gives the
same ``load_param_pack`` in both packages. A missing whitening pickle
raises alike.
"""

import pickle

import numpy as np
import pytest
import scipy.io as sio

from synergynet_tpu.mm3d import assets as jassets
from synergynet_tpu_torch.mm3d import assets

NV, NT = 300, 500


def _arrays(seed):
    rng = np.random.default_rng(seed)
    kp = rng.choice(NV, 68, replace=False)
    return {
        "u_shp": rng.normal(0, 30, (3 * NV, 1)),
        "u_exp": rng.normal(0, 1, (3 * NV, 1)),
        "w_shp": rng.normal(0, 5, (3 * NV, 60)),
        "w_exp": rng.normal(0, 2, (3 * NV, 29)),
        "kp": kp,
        "tri": rng.integers(0, NV, (3, NT)),
        "param_mean": rng.normal(0, 1, 102).astype(np.float32),
        "param_std": rng.uniform(0.5, 2, 102).astype(np.float32),
    }


def _write_pkl(path, a):
    with open(path, "wb") as f:
        pickle.dump({"param_mean": a["param_mean"],
                     "param_std": a["param_std"]}, f)
    return str(path)


def _reference_tree(d, a, with_tri):
    d.mkdir()
    np.save(d / "u_shp.npy", a["u_shp"])
    np.save(d / "u_exp.npy", a["u_exp"].astype(np.float32))
    np.save(d / "w_shp_sim.npy", a["w_shp"][:, :40])
    np.save(d / "w_exp_sim.npy", a["w_exp"][:, :10])
    kp = a["kp"]
    np.save(d / "keypoints_sim.npy",
            np.stack([3 * kp, 3 * kp + 1, 3 * kp + 2], 1).reshape(-1))
    _write_pkl(d / "param_whitening.pkl", a)
    if with_tri:
        sio.savemat(str(d / "tri.mat"), {"tri": (a["tri"] + 1).astype(
            np.float64)})
    return str(d)


def _raw_bfm(path, a, with_tri):
    model = {"w": a["w_shp"], "w_exp": a["w_exp"], "mu_shape": a["u_shp"],
             "mu_exp": a["u_exp"],
             "keypoints": (a["kp"] + 1.0)[None, :]}
    if with_tri:
        model["tri"] = a["tri"] + 1
    sio.savemat(str(path), {"model_refine": model})
    return str(path)


def _assert_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("with_tri", [True, False])
def test_convert_reference_assets_matches(tmp_path, with_tri):
    a = _arrays(1)
    d = _reference_tree(tmp_path / "3dmm_data", a, with_tri)
    got = assets.convert_reference_assets(d)
    _assert_dicts_equal(got, jassets.convert_reference_assets(d))
    assert got["w_shp"].shape == (3 * NV, 40)
    assert got["tri"].shape == ((3, NT) if with_tri else (3, 0))
    if with_tri:
        assert np.array_equal(got["tri"], a["tri"])


@pytest.mark.parametrize("own_tri,tri_file,pkl", [
    (True, False, True), (True, False, False), (False, True, True),
    (False, False, True), (True, True, False)])
def test_convert_raw_bfm_matches(tmp_path, own_tri, tri_file, pkl):
    a = _arrays(2)
    mat = _raw_bfm(tmp_path / "BFM_model_front.mat", a, own_tri)
    tri_path = None
    if tri_file:
        tri_path = str(tmp_path / "tri.mat")
        sio.savemat(tri_path, {"tri": (a["tri"][::-1] + 1).astype(
            np.float64)})
    pkl_path = _write_pkl(tmp_path / "w.pkl", a) if pkl else None
    got = assets.convert_raw_bfm(mat, pkl_path, tri_path)
    _assert_dicts_equal(got, jassets.convert_raw_bfm(mat, pkl_path,
                                                     tri_path))
    # the reference's recipe: trim, 0-based, keypoint triplets
    assert np.array_equal(got["w_shp"], a["w_shp"][:, :40].astype(
        np.float32))
    assert np.array_equal(got["w_exp"], a["w_exp"][:, :10].astype(
        np.float32))
    kp = a["kp"]
    assert np.array_equal(got["keypoints"], np.stack(
        [3 * kp, 3 * kp + 1, 3 * kp + 2], 1).reshape(-1))
    want_tri = (a["tri"][::-1] if tri_file else a["tri"] if own_tri
                else np.zeros((3, 0), np.int64))
    assert np.array_equal(got["tri"], want_tri)
    assert got["param_mean"].shape == ((102,) if pkl else (62,))


def test_convert_raw_bfm_trims_to_the_given_counts(tmp_path):
    a = _arrays(3)
    mat = _raw_bfm(tmp_path / "bfm.mat", a, True)
    got = assets.convert_raw_bfm(mat, n_shp=20, n_exp=5)
    _assert_dicts_equal(got, jassets.convert_raw_bfm(mat, n_shp=20,
                                                     n_exp=5))
    assert got["w_shp"].shape == (3 * NV, 20)


def test_missing_whitening_raises_alike(tmp_path):
    a = _arrays(4)
    d = _reference_tree(tmp_path / "3dmm_data", a, False)
    (tmp_path / "3dmm_data" / "param_whitening.pkl").unlink()
    with pytest.raises(FileNotFoundError) as e_port:
        assets.convert_reference_assets(d)
    with pytest.raises(FileNotFoundError) as e_jax:
        jassets.convert_reference_assets(d)
    assert str(e_port.value) == str(e_jax.value)


@pytest.mark.parametrize("source", ["reference", "raw"])
def test_converted_pack_loads_alike_through_synergy_bfm(tmp_path,
                                                        monkeypatch, source):
    a = _arrays(5)
    if source == "reference":
        d = assets.convert_reference_assets(
            _reference_tree(tmp_path / "3dmm_data", a, True))
    else:
        d = assets.convert_raw_bfm(
            _raw_bfm(tmp_path / "bfm.mat", a, True),
            _write_pkl(tmp_path / "w.pkl", a))
    path = str(tmp_path / f"converted_{source}.npz")
    assets.save_assets_npz(path, d)
    _assert_dicts_equal(assets.load_assets_npz(path),
                        jassets.load_assets_npz(path))
    monkeypatch.setenv("SYNERGY_BFM", path)
    got, want = assets.load_param_pack(), jassets.load_param_pack()
    assert got is assets.load_param_pack()          # cached by path
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        g = g.numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got.nver == want.nver == NV and got.ntri == want.ntri == NT
    dev = assets.device_pack(got, "cpu")
    assert all(x.device.type == "cpu" for x in dev)
