"""The port's Trainer and training CLI on the CPU: ``fit`` for one epoch
on 64 synthetic crops at full width (MobileNetV2 1.0, bf16, the JAX
default config cut to a small dataset and batch), resume, the emergency
save, a port checkpoint restored by the JAX ``restore_checkpoint``, the
config's JSON round trip with the JAX package's, and the CLI."""

import json
import logging

import jax
import numpy as np
import pytest
import torch

from synergynet_tpu.core import Config as JaxConfig
from synergynet_tpu.core.checkpoint import restore_checkpoint as jax_restore
from synergynet_tpu.nn import SynergyNet as JaxSynergyNet
from synergynet_tpu.train import lr_per_step as jax_lr
from synergynet_tpu.train import step as jstep
from synergynet_tpu_torch.cli import train as cli
from synergynet_tpu_torch.core.checkpoint import (checkpoint_metadata,
                                                  restore_checkpoint)
from synergynet_tpu_torch.core.config import Config
from synergynet_tpu_torch.train import Trainer, make_synthetic_eval_hook

torch.set_num_threads(2)


def _cfg(tmp_path, **train):
    cfg = Config()
    cfg.data.synthetic_size = 64
    cfg.train.batch_size = 16
    cfg.train.num_workers = 2
    cfg.train.epochs = 1
    cfg.train.print_freq = 2
    cfg.train.snapshot_dir = str(tmp_path / "ck")
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield "/".join(prefix + (str(k),)), np.asarray(v)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit")
    tr = Trainer(_cfg(tmp), eval_hook=make_synthetic_eval_hook(n=32),
                 device="cpu")
    history = tr.fit()
    return tr, history, tmp


def test_fit_one_epoch(fitted):
    tr, history, tmp = fitted
    assert list(history) == [1]
    h = history[1]
    for k in ("loss_LMK_f0", "loss_Param_In", "loss_LMK_pointNet",
              "loss_Param_S2", "loss_Param_S1S2", "loss_total"):
        assert np.isfinite(h[k]), k
    assert h["skipped"] == 0.0
    assert np.isfinite(h["eval"]["nme_mean"])
    assert int(tr.state.step) == int(tr.state.count) == 4
    assert (tmp / "ck" / "synergynet_epoch_1.npz").exists()
    assert checkpoint_metadata(str(tmp / "ck" / "synergynet_epoch_1.npz")
                               )["epoch"] == 1
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())


def test_resume_restores_the_state(fitted):
    tr, _, tmp = fitted
    path = str(tmp / "ck" / "synergynet_epoch_1.npz")
    cfg = _cfg(tmp, resume=path, epochs=2)
    tr2 = Trainer(cfg, device="cpu")
    assert tr2.start_epoch == 2
    for name in ("params", "stats", "trace", "count", "step"):
        assert torch.equal(getattr(tr2.state, name),
                           getattr(tr.state, name)), name
    history = tr2.fit()
    assert list(history) == [2]
    assert int(tr2.state.step) == 8


def test_emergency_save_on_failure(tmp_path):
    tr = Trainer(_cfg(tmp_path), device="cpu")
    real = tr.step_fn
    calls = []

    def failing(state, *args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("device lost")
        return real(state, *args)
    tr.step_fn = failing
    with pytest.raises(RuntimeError, match="device lost"):
        tr.fit()
    path = tmp_path / "ck" / "synergynet_emergency.npz"
    meta = checkpoint_metadata(str(path))
    assert meta["emergency"] and meta["epoch"] == 0 and meta["step"] == 2
    restored = restore_checkpoint(str(path), tr.state.tree())
    assert int(restored["step"]) == 2


def test_port_checkpoint_restores_in_jax(fitted):
    """The JAX ``restore_checkpoint`` reads the port's checkpoint into a
    JAX ``TrainState`` of the same config: every leaf, with its shape."""
    tr, _, tmp = fitted
    path = str(tmp / "ck" / "synergynet_epoch_1.npz")
    t = tr.cfg.train
    opt = jstep.make_optimizer(jax_lr(t.base_lr, t.milestones, t.warmup, 4),
                               momentum=t.momentum, nesterov=t.nesterov,
                               weight_decay=t.weight_decay)
    template = jax.device_get(jstep.create_train_state(
        JaxSynergyNet(), jax.random.PRNGKey(3), opt))
    restored = jax_restore(path, template)
    mine = tr.state.tree()
    assert int(restored.step) == 4
    assert int(restored.opt_state[2].count) == 4
    for name, jtree in (("params", restored.params),
                        ("batch_stats", restored.batch_stats)):
        want = dict(_leaves(mine[name]))
        got = dict(_leaves(jtree))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got = dict(_leaves(restored.opt_state[1].trace))
    for k, v in _leaves(mine["opt_state"]["1"]["trace"]):
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_config_json_round_trips_with_jax(tmp_path):
    cfg = _cfg(tmp_path)
    cfg.train.milestones = (3, 7)
    jc = JaxConfig.from_json(cfg.to_json())
    assert json.loads(jc.to_json()) == json.loads(cfg.to_json())
    assert Config.from_json(JaxConfig().to_json()) == Config()


def test_not_ported_options_raise(tmp_path):
    cfg = _cfg(tmp_path)
    cfg.data.device_augment = True
    with pytest.raises(NotImplementedError, match="device_augment"):
        Trainer(cfg, device="cpu")
    cfg = _cfg(tmp_path)
    cfg.data.streaming = True
    with pytest.raises(NotImplementedError, match="streaming"):
        Trainer(cfg, device="cpu")
    cfg = _cfg(tmp_path, per_replica_bn=True)
    with pytest.raises(NotImplementedError, match="bn_groups"):
        Trainer(cfg, device="cpu")


def test_cli_trains_with_no_eval(tmp_path):
    args = ["--platform", "cpu", "--no-eval", "--synthetic-size", "32",
            "--batch-size", "16", "--epochs", "1", "--workers", "2",
            "--snapshot-dir", str(tmp_path / "ck"),
            "--log-file", str(tmp_path / "train.log")]
    try:
        history = cli.main(args)
    finally:
        for h in list(logging.getLogger().handlers):
            logging.getLogger().removeHandler(h)
            h.close()
    assert np.isfinite(history[1]["loss_total"])
    assert "eval" not in history[1]
    assert (tmp_path / "ck" / "synergynet_epoch_1.npz").exists()
    assert "training on cpu" in (tmp_path / "train.log").read_text()


@pytest.mark.parametrize("flags", [["--coordinator", "localhost:1234"],
                                   ["--num-processes", "2"],
                                   ["--process-id", "1"],
                                   ["--n-model", "2"], ["--resident"]])
def test_cli_refuses_what_is_not_ported(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(flags + ["--platform", "cpu"])
