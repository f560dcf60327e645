"""The port's streaming dataset and the loader's ``fetch_batch`` fast path
against the JAX package's, and the Trainer on them.

The "dots" dataset is numpy on both sides with the same draws (the
background bank from ``seed + 1``, the parameters from ``seed``); the
landmarks are decoded by each package in fp32 and agree to 1e-4 px, and
the crops are held equal byte for byte on these seeds (a dot could move
by a pixel only where a coordinate sits within rounding of a half-pixel,
as ``test_torch_train_data.py`` says of the materialized crops).
"""

import numpy as np
import pytest
import torch

from synergynet_tpu import data as jdata
from synergynet_tpu.mm3d import load_param_pack as jload_pack
from synergynet_tpu_torch import data as tdata
from synergynet_tpu_torch.core.config import Config
from synergynet_tpu_torch.mm3d import load_param_pack
from synergynet_tpu_torch.train import Trainer, build_augment, build_dataset
from synergynet_tpu_torch.train import trainer as trainer_mod

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pack():
    return load_param_pack()


@pytest.mark.parametrize("n,seed", [(64, 3), (1500, 0)])
def test_dots_dataset_matches_jax(pack, n, seed):
    j = jdata.GeneratedCropDataset(n, jload_pack(), seed=seed)
    t = tdata.GeneratedCropDataset(n, pack, seed=seed, device="cpu")
    assert len(t) == len(j) == n
    np.testing.assert_array_equal(t.params, j.params)
    np.testing.assert_array_equal(t._bg_bank, j._bg_bank)
    np.testing.assert_allclose(t.lmk, j.lmk, rtol=0, atol=1e-4)
    idx = np.random.default_rng(seed).permutation(n)
    np.testing.assert_array_equal(t.generate_images(idx),
                                  j.generate_images(idx))


@pytest.mark.parametrize("appearance", ["dots", "shaded"])
def test_fetch_batch_equals_getitem(pack, appearance):
    ds = tdata.GeneratedCropDataset(20, pack, seed=4, appearance=appearance,
                                    device="cpu")
    idx = np.asarray([7, 3, 19, 3, 0])
    images, params = ds.fetch_batch(idx)
    assert images.shape == (5, 120, 120, 3) and images.dtype == np.uint8
    for row, i in enumerate(idx):
        img, p = ds[i]
        np.testing.assert_array_equal(images[row], img)
        np.testing.assert_array_equal(params[row], p)
    assert not np.array_equal(images[0], images[1])


@pytest.mark.parametrize("workers", [1, 4])
def test_fast_path_batches_match_jax_loader(pack, workers):
    """Two epochs of the fast path (slabs of >= 128 crops per thread) give
    the JAX loader's batches, whatever the thread count."""
    n, kw = 1100, dict(batch_size=512, shuffle=True, drop_last=True, seed=3)
    jl = jdata.PrefetchLoader(jdata.GeneratedCropDataset(n, jload_pack(),
                                                         seed=2),
                              num_workers=2, **kw)
    tds = tdata.GeneratedCropDataset(n, pack, seed=2, device="cpu")
    tl = tdata.PrefetchLoader(tds, num_workers=workers, **kw)
    calls = []
    real = tds.fetch_batch
    tds.fetch_batch = lambda idx: calls.append(len(idx)) or real(idx)
    assert len(tl) == len(jl) == 2
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == 2
        for (gi, gp), (wi, wp) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gp, wp)
    assert sum(calls) == 2 * 2 * 512
    assert max(calls) <= 512 // min(workers, 4) + 1


def test_transform_takes_the_per_item_path(pack):
    """With a host transform the loader fetches item by item, as the JAX
    loader does, and both give the same augmented bytes."""
    kw = dict(batch_size=8, shuffle=True, drop_last=True, seed=1,
              num_workers=2)
    jl = jdata.PrefetchLoader(jdata.GeneratedCropDataset(
        24, jload_pack(), seed=5, transform=jdata.TrainTransform(
            occlusion_prob=0.5)), **kw)
    tds = tdata.GeneratedCropDataset(24, pack, seed=5,
                                     transform=tdata.TrainTransform(
                                         occlusion_prob=0.5), device="cpu")
    tds.fetch_batch = None
    tl = tdata.PrefetchLoader(tds, **kw)
    for (gi, gp), (wi, wp) in zip(list(tl), list(jl)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gp, wp)


def test_build_dataset_streams_and_drops_the_host_transform(monkeypatch):
    cfg = Config()
    cfg.data.synthetic_size = 100_001
    made = []
    orig = tdata.GeneratedCropDataset.__init__

    def tiny(self, n, **kw):
        made.append(n)
        orig(self, 32, **kw)
    monkeypatch.setattr(tdata.GeneratedCropDataset, "__init__", tiny)
    ds = build_dataset(cfg, "cpu")
    assert isinstance(ds, tdata.GeneratedCropDataset) and made == [100_001]
    assert isinstance(ds.transform, tdata.TrainTransform)
    assert build_augment(cfg) is None
    cfg.data.synthetic_size = 40
    cfg.data.streaming = True
    cfg.data.device_augment = True
    cfg.data.appearance = "shaded"
    ds = build_dataset(cfg, "cpu")
    assert isinstance(ds, tdata.GeneratedCropDataset)
    assert ds.transform is None and ds.appearance == "shaded"
    aug = build_augment(cfg)
    assert aug.keywords == dict(jitter=(0.4, 0.4, 0.4), border=5,
                                occlusion_prob=0.01)
    cfg.data.streaming = False
    ds = build_dataset(cfg, "cpu")
    assert isinstance(ds, tdata.ArrayDataset) and ds.transform is None


def test_trainer_fits_a_stream_with_device_augment(tmp_path, monkeypatch):
    """``Trainer.fit`` at full width on streamed crops through the fast
    path, the step augmenting on the device with the seeds of
    ``(seed, epoch, step, 7)``."""
    cfg = Config()
    cfg.data.synthetic_size = 32
    cfg.data.streaming = True
    cfg.data.device_augment = True
    cfg.train.batch_size = 16
    cfg.train.num_workers = 2
    cfg.train.snapshot_dir = str(tmp_path / "ck")
    tr = Trainer(cfg, device="cpu")
    assert tr.dataset.transform is None and tr.augment is not None
    seeds = []
    monkeypatch.setattr(trainer_mod, "augment_seed",
                        lambda *a: seeds.append(a) or 17 + len(seeds))
    history = tr.fit(1)
    assert seeds == [(0, 1, 0), (0, 1, 1)]
    h = history[1]
    assert np.isfinite(h["loss_total"]) and h["skipped"] == 0.0
    assert int(tr.state.step) == 2


def test_step_with_augment_equals_augmenting_first():
    """The step built with ``augment=`` equals the plain step fed the same
    augmentation, normalized, as a float batch."""
    from synergynet_tpu_torch.data.device_augment import device_augment
    from synergynet_tpu_torch.nn import SynergyNet
    from synergynet_tpu_torch.train import (create_train_state,
                                            make_optimizer, make_train_step)
    pack = load_param_pack()
    opt = make_optimizer(lambda c: 0.01)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 120, 120, 3), np.uint8))
    tgts = torch.from_numpy(np.random.default_rng(1).normal(
        0, 0.4, (4, 62)).astype(np.float32))
    states = []
    for aug in (True, False):
        st = create_train_state(SynergyNet(dropout=0.0),
                                torch.Generator().manual_seed(0), opt)
        if aug:
            step = make_train_step(pack, opt, device="cpu",
                                   augment=device_augment)
            with pytest.raises(ValueError, match="augment_seed"):
                step(st, imgs, tgts)
            step(st, imgs, tgts, augment_seed=9)
        else:
            x = (device_augment(imgs, 9) - 127.5) / 128.0
            make_train_step(pack, opt, device="cpu")(st, x, tgts)
        states.append(st)
    for name in ("params", "stats", "trace"):
        torch.testing.assert_close(getattr(states[0], name),
                                   getattr(states[1], name), rtol=0, atol=0)
