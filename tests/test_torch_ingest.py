"""The port's reference-layout ingest against the JAX package's, on the CPU.

Seeded trees in the reference's layouts are written into ``tmp_path``
(sizes stated at each fixture) and loaded by both packages:

- an ``aflw2000_data`` tree of 16 jpg crops (two of them 100x100 and
  140x120, so the loader's resize runs) with every ``eval/`` array, then
  without the skip file (skips derived from the yaws), without the FOE
  file, with ``limit``, ``reannotated`` and ``load_images=False``: the
  packs equal key for key and array for array (dtypes included), the
  crops bit for bit;
- a 300W-LP tree of 12 jpg crops with a 102-d parameter pickle: the
  ``FileListDataset`` samples equal;
- the errors for a missing directory and an incomplete layout equal;
- ``save_eval_pack`` round-trips, and each package reads the other's file;
- ``load_reference_array`` (a pickle, an object ``.npy``) and
  ``read_filelist`` equal.
"""

import os
import os.path as osp
import pickle
import sys

import cv2
import numpy as np
import pytest

from synergynet_tpu.data import ingest as jingest
from synergynet_tpu.data import make_synthetic_aflw2000 as jax_aflw
from synergynet_tpu_torch.data import ingest

N_AFLW = 16
N_WLP = 12


@pytest.fixture(scope="module")
def synth():
    return jax_aflw(N_AFLW, seed=3)


def _write_aflw(base, sp, *, skip=True, excl=True):
    crop = base / "AFLW2000-3D_crop"
    ev = base / "eval"
    crop.mkdir(parents=True)
    ev.mkdir()
    names = []
    for i, img in enumerate(sp["images"]):
        if i == 1:
            img = cv2.resize(img, (100, 100))
        elif i == 2:
            img = cv2.resize(img, (140, 120))
        name = f"image{i:05d}.jpg"
        cv2.imwrite(str(crop / name), img)
        names.append(name)
    (base / "AFLW2000-3D_crop.list").write_text("\n".join(names) + "\n")
    np.save(ev / "AFLW2000-3D.pose.npy", sp["yaws"].astype(np.float64))
    np.save(ev / "AFLW2000-3D.pts68.npy", sp["pts68_gt"])
    np.save(ev / "AFLW2000-3D-Reannotated.pts68.npy", sp["pts68_gt"] + 0.5)
    np.save(ev / "AFLW2000-3D_crop.roi_box.npy", sp["roi_boxes"])
    if excl:
        np.save(ev / "ALFW2000-3D_pose_3ANG_excl.npy", sp["pose_gt_pyr"])
    if skip:
        np.save(ev / "ALFW2000-3D_pose_3ANG_skip.npy", sp["skip_indices"])
    return str(base)


@pytest.fixture(scope="module")
def aflw_dirs(tmp_path_factory, synth):
    root = tmp_path_factory.mktemp("aflw")
    # Yaws past 99 degrees in some rows, so derived skips are not empty.
    sp = dict(synth)
    sp["yaws"] = synth["yaws"].copy()
    sp["yaws"][[4, 9]] = [120.0, -105.0]
    sp["skip_indices"] = np.asarray([4, 9], np.int64)
    return {"full": _write_aflw(root / "full", sp),
            "no_skip": _write_aflw(root / "no_skip", sp, skip=False),
            "no_excl": _write_aflw(root / "no_excl", sp, excl=False)}


def _assert_packs_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("tree,kw", [
    ("full", {}),
    ("full", {"limit": 5}),
    ("full", {"limit": 40}),
    ("full", {"reannotated": True}),
    ("full", {"load_images": False}),
    ("no_skip", {}),
    ("no_skip", {"limit": 7}),
    ("no_excl", {}),
])
def test_load_aflw2000_dir_matches(aflw_dirs, tree, kw):
    want = jingest.load_aflw2000_dir(aflw_dirs[tree], **kw)
    got = ingest.load_aflw2000_dir(aflw_dirs[tree], **kw)
    _assert_packs_equal(got, want)
    n = min(kw.get("limit", N_AFLW), N_AFLW)
    assert len(got["yaws"]) == n
    assert ("pose_gt_pyr" in got) == (tree != "no_excl" and "limit" not in kw)
    assert ("images" in got) == kw.get("load_images", True)
    if tree == "no_skip":
        assert got["skip_indices"].tolist() == [i for i in (4, 9) if i < n]


def test_reannotated_selects_its_file(aflw_dirs):
    a = ingest.load_aflw2000_dir(aflw_dirs["full"], load_images=False)
    b = ingest.load_aflw2000_dir(aflw_dirs["full"], load_images=False,
                                 reannotated=True)
    np.testing.assert_array_equal(b["pts68_gt"], a["pts68_gt"] + 0.5)


def test_crops_equal_bit_for_bit(aflw_dirs):
    crop_root = osp.join(aflw_dirs["full"], ingest.AFLW2000_CROP_DIR)
    names = ingest.read_filelist(osp.join(aflw_dirs["full"],
                                          ingest.AFLW2000_CROP_LIST))
    assert names == jingest.read_filelist(osp.join(
        aflw_dirs["full"], jingest.AFLW2000_CROP_LIST))
    got = ingest.load_crop_images(crop_root, names)
    want = jingest.load_crop_images(crop_root, names)
    assert got.shape == (N_AFLW, 120, 120, 3) and got.dtype == np.uint8
    assert np.array_equal(got, want)
    with pytest.raises(FileNotFoundError) as e_port:
        ingest.load_crop_images(crop_root, ["missing.jpg"])
    with pytest.raises(FileNotFoundError) as e_jax:
        jingest.load_crop_images(crop_root, ["missing.jpg"])
    assert str(e_port.value) == str(e_jax.value)


def test_layout_names_are_the_reference_files():
    assert ingest.AFLW2000_EVAL_FILES == jingest.AFLW2000_EVAL_FILES
    assert ingest.AFLW2000_CROP_DIR == jingest.AFLW2000_CROP_DIR
    assert ingest.AFLW2000_CROP_LIST == jingest.AFLW2000_CROP_LIST
    assert ingest.AFLW2000_EVAL_FILES["pose_gt_pyr"].startswith("ALFW")


def _raised(fn, *args):
    with pytest.raises(Exception) as e:
        fn(*args)
    return type(e.value), str(e.value)


def test_missing_dir_and_incomplete_layouts_raise_alike(tmp_path,
                                                        aflw_dirs):
    nowhere = str(tmp_path / "nowhere")
    got = _raised(ingest.load_aflw2000_dir, nowhere)
    assert got == _raised(jingest.load_aflw2000_dir, nowhere)
    assert got[0] is RuntimeError and "testing data" in got[1]
    got = _raised(ingest.load_300wlp_dir, nowhere)
    assert got == _raised(jingest.load_300wlp_dir, nowhere)
    assert got[0] is RuntimeError and "incomplete" in got[1]
    # the list present, the crop dir not
    half = tmp_path / "half"
    half.mkdir()
    (half / "AFLW2000-3D_crop.list").write_text("a.jpg\n")
    assert _raised(ingest.load_aflw2000_dir, str(half)) == \
        _raised(jingest.load_aflw2000_dir, str(half))


def test_save_eval_pack_round_trips(aflw_dirs, tmp_path):
    pack = ingest.load_aflw2000_dir(aflw_dirs["full"])
    out = ingest.save_eval_pack(pack, str(tmp_path / "port.npz"))
    assert out == str(tmp_path / "port.npz")
    with np.load(out) as z:
        _assert_packs_equal({k: z[k] for k in z.files}, pack)
    jout = jingest.save_eval_pack(pack, str(tmp_path / "jax.npz"))
    with np.load(jout) as a, np.load(out) as b:
        _assert_packs_equal({k: a[k] for k in a.files},
                            {k: b[k] for k in b.files})


def test_load_reference_array_and_filelist(tmp_path):
    obj = np.empty(3, object)
    obj[:] = [np.arange(3.0), np.ones((2, 2)), "x"]
    np.save(tmp_path / "obj.npy", obj, allow_pickle=True)
    with open(tmp_path / "meta.pkl", "wb") as f:
        pickle.dump({"param_mean": np.arange(62.0)}, f)
    for name in ("obj.npy", "meta.pkl"):
        got = ingest.load_reference_array(str(tmp_path / name))
        want = jingest.load_reference_array(str(tmp_path / name))
        assert type(got) is type(want)
        if name == "obj.npy":
            assert got.dtype == object and len(got) == 3
            np.testing.assert_array_equal(got[1], want[1])
        else:
            np.testing.assert_array_equal(got["param_mean"],
                                          want["param_mean"])
    (tmp_path / "l.txt").write_text("\n a.jpg\nb.jpg\n\n")
    assert ingest.read_filelist(str(tmp_path / "l.txt")) == \
        jingest.read_filelist(str(tmp_path / "l.txt")) == ["a.jpg", "b.jpg"]


@pytest.fixture(scope="module")
def wlp_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("ref_root")
    (base / "train_aug_120x120").mkdir()
    (base / "3dmm_data").mkdir()
    rng = np.random.default_rng(5)
    names = []
    for i in range(N_WLP):
        name = f"LFPW_image_train_{i:04d}_0.jpg"
        cv2.imwrite(str(base / "train_aug_120x120" / name),
                    rng.integers(0, 255, (120, 120, 3), np.uint8))
        names.append(name)
    (base / "3dmm_data" / "train_aug_120x120.list.train").write_text(
        "\n".join(names) + "\n")
    with open(base / "3dmm_data" / "param_all_norm_v201.pkl", "wb") as f:
        pickle.dump(rng.normal(0, 1, (N_WLP, 102)).astype(np.float32), f)
    return str(base)


def test_load_300wlp_dir_samples_match(wlp_dir):
    from synergynet_tpu.data import TrainTransform as JaxTrainTransform
    from synergynet_tpu_torch.data import TrainTransform
    jd = jingest.load_300wlp_dir(wlp_dir)
    td = ingest.load_300wlp_dir(wlp_dir)
    assert len(td) == len(jd) == N_WLP
    for i in range(N_WLP):
        (a, pa), (b, pb) = jd[i], td[i]
        assert b.dtype == np.uint8 and b.shape == (120, 120, 3)
        assert np.array_equal(a, b)
        assert pb.shape == (62,) and np.array_equal(pa, pb)
    jd = jingest.load_300wlp_dir(wlp_dir, transform=JaxTrainTransform())
    td = ingest.load_300wlp_dir(wlp_dir, transform=TrainTransform())
    for i in (0, 5):
        (a, _), (b, _) = (jd.__getitem__(i, np.random.default_rng(i)),
                          td.__getitem__(i, np.random.default_rng(i)))
        np.testing.assert_array_equal(a, b)


def test_missing_cv2_names_opencv(aflw_dirs, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        ingest.load_aflw2000_dir(aflw_dirs["full"])
    pack = ingest.load_aflw2000_dir(aflw_dirs["full"], load_images=False)
    assert "images" not in pack and len(pack["yaws"]) == N_AFLW
    assert os.path.isdir(aflw_dirs["full"])
