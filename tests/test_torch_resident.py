"""Device-resident training on the CPU: ``fit_resident`` and
``fit_resident_generative`` at full width (MobileNetV2 1.0), tiny datasets.

A resident epoch is the host loop's steps over the epoch's permutation,
bit for bit; a generative batch is ``render_shaded_crops`` of the same
parameters and keys; a few generative epochs lower the loss, as the JAX
package's ``tests/test_shaded.py`` shows for its epoch program; and the
checkpoint, history, eval and emergency-save contract is ``Trainer.fit``'s.
"""

import numpy as np
import pytest
import torch

from synergynet_tpu_torch.core.checkpoint import checkpoint_metadata
from synergynet_tpu_torch.core.config import Config
from synergynet_tpu_torch.data import keyed, make_crops_with_params
from synergynet_tpu_torch.data.shaded import render_shaded_crops
from synergynet_tpu_torch.train import (Trainer, fit_resident,
                                        fit_resident_generative, resident)
from synergynet_tpu_torch.train.trainer import augment_seed, dropout_seed

torch.set_num_threads(2)


def _cfg(tmp_path, n=32, batch=16, **data):
    cfg = Config()
    cfg.data.synthetic_size = n
    cfg.train.batch_size = batch
    cfg.train.num_workers = 2
    cfg.train.snapshot_dir = str(tmp_path / "ck")
    for k, v in data.items():
        setattr(cfg.data, k, v)
    return cfg


def _state(tr):
    return [getattr(tr.state, k).clone() for k in
            ("params", "stats", "trace", "count", "step")]


def test_resident_epoch_equals_the_host_loop(tmp_path):
    """fp32, device augmentation on: one resident epoch equals the step run
    by hand over the epoch's permutation, with the same seeds."""
    cfg = _cfg(tmp_path, device_augment=True)
    cfg.model.compute_dtype = "float32"
    data = make_crops_with_params(32, seed=0, device="cpu")
    a, b = Trainer(cfg, device="cpu"), Trainer(cfg, device="cpu")
    history = fit_resident(a, data["images"], data["params"], epochs=1)
    perm = resident.epoch_permutation(0, 1, 32, "cpu")
    sums = None
    for i in range(2):
        idx = perm[i * 16:(i + 1) * 16].numpy()
        b.dropout.manual_seed(dropout_seed(0, 1, i))
        _, m = b.step_fn(b.state, torch.from_numpy(data["images"][idx]),
                         torch.from_numpy(data["params"][idx]), b.dropout,
                         augment_seed(0, 1, i))
        sums = m if sums is None else {k: sums[k] + m[k] for k in m}
    for x, y in zip(_state(a), _state(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert history[1] == {k: float(v) / 2 for k, v in sums.items()}
    assert int(a.state.step) == 2 and history[1]["skipped"] == 0.0
    assert sorted(resident.epoch_permutation(0, 1, 32, "cpu").tolist()) == \
        list(range(32))
    assert not torch.equal(perm, resident.epoch_permutation(0, 2, 32, "cpu"))


def test_generative_batch_is_the_rendered_crops(tmp_path):
    tr = Trainer(_cfg(tmp_path, streaming=True, appearance="shaded"),
                 device="cpu")
    params = torch.from_numpy(tr.dataset.params)
    idx = torch.tensor([9, 2, 30, 2])
    images, target = resident.generative_batch(params, idx, tr.pack, 0, 3)
    torch.testing.assert_close(target, params[idx], rtol=0, atol=0)
    want = render_shaded_crops(params[idx], tr.pack,
                               keyed.make_key(0, 3, resident.RENDER_STREAM),
                               idx)
    torch.testing.assert_close(images, want, rtol=0, atol=0)
    other, _ = resident.generative_batch(params, idx, tr.pack, 0, 4)
    assert (other != images).float().mean() > 0.1      # relit each epoch
    # The host-rendered dataset keys crop i by (seed, i) alone.
    np.testing.assert_array_equal(
        tr.dataset.generate_images(idx.numpy()),
        render_shaded_crops(params[idx], tr.pack, keyed.make_key(0),
                            idx).numpy())


def test_generative_epochs_lower_the_loss(tmp_path):
    """8 epochs of 2 steps on 32 shaded parameters, lighting and
    background re-rolled each epoch: the loss falls below its first
    epoch's (the JAX test's check)."""
    cfg = _cfg(tmp_path, streaming=True, appearance="shaded")
    cfg.train.base_lr = 0.002
    cfg.train.warmup = 0
    cfg.train.save_val_freq = 100
    tr = Trainer(cfg, device="cpu")
    losses = []
    history = fit_resident_generative(
        tr, tr.dataset.params, epochs=8,
        log_fn=lambda e, m: losses.append(m["loss_total"]))
    assert list(history) == list(range(1, 9))
    assert int(tr.state.step) == 16
    assert all(h["skipped"] == 0.0 for h in history.values())
    assert np.isfinite(losses).all()
    assert min(losses[4:]) < losses[0]


def test_checkpoint_history_eval_and_resume(tmp_path):
    from synergynet_tpu_torch.train import make_synthetic_eval_hook
    cfg = _cfg(tmp_path)
    cfg.train.save_val_freq = 1
    cfg.train.test_initial = True
    evals = []
    hook = make_synthetic_eval_hook(n=16, device="cpu")

    def counted(trainer):
        evals.append(int(trainer.state.step))
        return hook(trainer)
    tr = Trainer(cfg, eval_hook=counted, device="cpu")
    data = make_crops_with_params(32, seed=0, device="cpu")
    history = fit_resident(tr, data["images"], data["params"], epochs=2)
    assert list(history) == [1, 2] and evals == [0, 2, 4]
    assert np.isfinite(history[2]["eval"]["nme_mean"])
    for e in (1, 2):
        path = tmp_path / "ck" / f"synergynet_epoch_{e}.npz"
        assert checkpoint_metadata(str(path))["epoch"] == e
    cfg.train.resume = str(tmp_path / "ck" / "synergynet_epoch_2.npz")
    cfg.train.test_initial = False
    tr2 = Trainer(cfg, device="cpu")
    assert tr2.start_epoch == 3
    for x, y in zip(_state(tr2), _state(tr)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert list(fit_resident(tr2, data["images"], data["params"],
                             epochs=3)) == [3]
    assert int(tr2.state.step) == 6


def test_failure_saves_the_state_and_reraises(tmp_path):
    tr = Trainer(_cfg(tmp_path, streaming=True, appearance="shaded"),
                 device="cpu")
    real, calls = tr.step_fn, []

    def failing(state, *args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("device lost")
        return real(state, *args)
    tr.step_fn = failing
    with pytest.raises(RuntimeError, match="device lost"):
        fit_resident_generative(tr, tr.dataset.params, epochs=2)
    meta = checkpoint_metadata(str(tmp_path / "ck" /
                                   "synergynet_emergency.npz"))
    assert meta["emergency"] and meta["epoch"] == 1 and meta["step"] == 2


def test_dataset_size_must_match_the_schedule(tmp_path):
    tr = Trainer(_cfg(tmp_path), device="cpu")
    data = make_crops_with_params(48, seed=0, device="cpu")
    with pytest.raises(ValueError, match="3 steps of 16"):
        fit_resident(tr, data["images"], data["params"])
    with pytest.raises(ValueError, match="learning-rate schedule"):
        fit_resident_generative(tr, data["params"][:16])
