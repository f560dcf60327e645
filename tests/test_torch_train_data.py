"""The port's data pipeline against the JAX package's: transforms, the
loader's batches, the datasets and the synthetic data, from the same seeds.

The transforms and the loader are numpy on both sides with the same rng
calls, so their bytes are held equal. The synthetic crops paint dots at
landmarks decoded by each package (fp32, the decode differs by a few
1e-5 px), so a dot could move by a pixel where a coordinate sits at a
half-pixel: the images are held equal on these seeds, and the landmarks
to atol 1e-4 px.
"""

import os
import sys

import jax
import numpy as np
import pytest

from synergynet_tpu import data as jdata
from synergynet_tpu_torch import data as tdata

SEEDS = [0, 1, 7]


def _crops(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, 120, 120, 3), np.uint8)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_transform_is_bit_identical(seed):
    """Colour jitter (random op order) and border + occlusion, with
    occlusion forced on so every pattern (quirk Q2's rdown) is reached."""
    imgs = _crops(seed=seed)
    for prob in (0.01, 1.0):
        jt = jdata.TrainTransform(occlusion_prob=prob)
        tt = tdata.TrainTransform(occlusion_prob=prob)
        for i, im in enumerate(imgs):
            a = jt(im.copy(), np.random.default_rng([seed, i]))
            b = tt(im.copy(), np.random.default_rng([seed, i]))
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


def test_hue_and_test_transform_are_bit_identical():
    imgs = _crops(6, seed=3)
    jj, tj = jdata.ColorJitter(hue=0.5), tdata.ColorJitter(hue=0.5)
    for i, im in enumerate(imgs):
        np.testing.assert_array_equal(
            jj(im, np.random.default_rng(i)), tj(im, np.random.default_rng(i)))
        np.testing.assert_array_equal(jdata.TestTransform()(im),
                                      tdata.TestTransform()(im))


def test_normalize_images_matches():
    import torch
    u8 = _crops(2)
    got = tdata.normalize_images(torch.from_numpy(u8), std=130.0).numpy()
    want = np.asarray(jdata.normalize_images(u8, std=130.0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("workers", [1, 4])
def test_loader_batches_are_bit_identical(workers):
    """Two epochs of shuffled, augmented batches: the same order and the
    same per-sample rngs as the JAX loader, whatever the thread count."""
    imgs = _crops(40, seed=5)
    params = np.random.default_rng(6).normal(size=(40, 62)).astype(
        np.float32)
    kw = dict(batch_size=8, shuffle=True, drop_last=True, seed=3)
    jl = jdata.PrefetchLoader(jdata.ArrayDataset(
        imgs, params, jdata.TrainTransform(occlusion_prob=0.3)),
        num_workers=2, **kw)
    tl = tdata.PrefetchLoader(tdata.ArrayDataset(
        imgs, params, tdata.TrainTransform(occlusion_prob=0.3)),
        num_workers=workers, **kw)
    assert len(tl) == len(jl) == 5
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == 5
        for (gi, gp), (wi, wp) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gp, wp)


def test_loader_stops_early_and_reraises():
    ds = tdata.ArrayDataset(_crops(32), None)
    loader = tdata.PrefetchLoader(ds, 4, num_workers=2, prefetch=1)
    it = iter(loader)
    next(it)
    it.close()

    class Broken(tdata.ArrayDataset):
        def __getitem__(self, index, rng=None):
            raise OSError("unreadable")
    with pytest.raises(OSError, match="unreadable"):
        list(tdata.PrefetchLoader(Broken(_crops(8)), 4, num_workers=2))


def test_file_list_dataset_matches(tmp_path, monkeypatch):
    import cv2
    imgs = _crops(3, seed=8)
    names = []
    for i, im in enumerate(imgs):
        names.append(f"c{i}.png")
        cv2.imwrite(str(tmp_path / names[-1]), im)
    (tmp_path / "list.txt").write_text("\n".join(names))
    params = np.random.default_rng(9).normal(size=(3, 70)).astype(np.float32)
    np.save(tmp_path / "p.npy", params)
    args = (str(tmp_path), str(tmp_path / "list.txt"), str(tmp_path / "p.npy"))
    jd = jdata.FileListDataset(*args, transform=jdata.TrainTransform())
    td = tdata.FileListDataset(*args, transform=tdata.TrainTransform())
    assert len(td) == len(jd) == 3
    for i in range(3):
        (a, pa), (b, pb) = (jd.__getitem__(i, np.random.default_rng(i)),
                            td.__getitem__(i, np.random.default_rng(i)))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pa, pb)
        assert pb.shape == (62,)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        td[0]


@pytest.mark.parametrize("n,seed", [(64, 0), (300, 4)])
def test_synthetic_crops_match(n, seed):
    a = jdata.make_crops_with_params(n, seed=seed)
    b = tdata.make_crops_with_params(n, seed=seed, device="cpu")
    np.testing.assert_array_equal(b["params"], a["params"])
    np.testing.assert_allclose(b["landmarks"], a["landmarks"], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(b["images"], a["images"])


def test_synthetic_aflw2000_matches():
    a = jdata.make_synthetic_aflw2000(128, seed=11)
    b = tdata.make_synthetic_aflw2000(128, seed=11, device="cpu")
    assert sorted(a) == sorted(b)
    for k in ("images", "params", "roi_boxes", "skip_indices"):
        np.testing.assert_array_equal(b[k], np.asarray(a[k]), err_msg=k)
    for k in ("landmarks", "pts68_gt"):      # rescaled by up to 2x
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=2e-4, err_msg=k)
    for k in ("yaws", "pose_gt_pyr"):        # degrees
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-3, err_msg=k)


def test_shaded_contract_and_unknown_appearance():
    """"shaded" keeps the dots' dict contract (and its parameters); an
    unknown appearance raises, as in the JAX package."""
    dots = tdata.make_crops_with_params(4, seed=3, device="cpu")
    shaded = tdata.make_crops_with_params(4, seed=3, appearance="shaded",
                                          device="cpu")
    assert sorted(shaded) == sorted(dots)
    for k in dots:
        assert shaded[k].shape == dots[k].shape, k
        assert shaded[k].dtype == dots[k].dtype, k
    np.testing.assert_array_equal(shaded["params"], dots["params"])
    np.testing.assert_array_equal(shaded["landmarks"], dots["landmarks"])
    for appearance in ("other", "Shaded"):
        with pytest.raises(ValueError, match="unknown appearance"):
            tdata.make_crops_with_params(4, appearance=appearance)
        with pytest.raises(ValueError, match="unknown appearance"):
            tdata.GeneratedCropDataset(4, appearance=appearance)
