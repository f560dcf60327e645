"""The Trainer: epochs, meters, logging, checkpoints, in-train eval.

Counterpart of ``synergynet_tpu/train/trainer.py`` (reference
main_train.py:103-239) on one device, the card unless the caller asks for
the CPU:

- the train step of :mod:`synergynet_tpu_torch.train.step` (loss, grads,
  SGD and the NaN skip on the device);
- the reference's step-decay schedule, driven per applied update;
- ``AverageMeter`` logging, with the step's metrics read on the host only
  at print boundaries (``trainer.py:183-215``), so steps queue back to
  back on the card;
- checkpoints every ``save_val_freq`` epochs and at the end, in the JAX
  package's format, with resume and an emergency save on failure;
- an optional validation hook (:func:`make_synthetic_eval_hook`).

Without a 300W-LP filelist the Trainer trains on the dot-painted synthetic
dataset. The head's dropout draws from a generator seeded from
``(seed, epoch, step)``, as the JAX step folds its key
(``trainer.py:181``, ``step.py:108``).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from synergynet_tpu_torch.core.checkpoint import (checkpoint_metadata,
                                                  restore_checkpoint,
                                                  save_checkpoint)
from synergynet_tpu_torch.core.config import Config
from synergynet_tpu_torch.core.device import resolve_device
from synergynet_tpu_torch.data import (ArrayDataset, FileListDataset,
                                       PrefetchLoader, TrainTransform,
                                       make_crops_with_params)
from synergynet_tpu_torch.mm3d import load_param_pack
from synergynet_tpu_torch.nn import SynergyNet
from synergynet_tpu_torch.train.meters import AverageMeter, MeterBank
from synergynet_tpu_torch.train.schedule import lr_per_step
from synergynet_tpu_torch.train.step import (create_train_state,
                                             make_optimizer, make_train_step)

log = logging.getLogger("synergynet_tpu_torch.train")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"queue A: {item})")


def build_dataset(cfg: Config):
    d = cfg.data
    if d.device_augment:
        raise _not_ported("device-side augmentation (data.device_augment)",
                          "device_augment")
    transform = TrainTransform(d.jitter, d.border, d.occlusion_prob)
    if d.filelists_train and os.path.exists(d.filelists_train):
        return FileListDataset(d.root, d.filelists_train, d.param_fp_train,
                               transform=transform)
    if d.synthetic_size > 100_000 or d.streaming:
        raise _not_ported("the streaming synthetic dataset (data.streaming,"
                          " or more than 100,000 crops)", "streaming")
    log.info("no 300W-LP filelist configured; using synthetic dataset "
             "(%d crops)", d.synthetic_size)
    syn = make_crops_with_params(d.synthetic_size, seed=cfg.train.seed,
                                 appearance=d.appearance)
    return ArrayDataset(syn["images"], syn["params"], transform=transform)


def dropout_seed(seed: int, epoch: int, step: int) -> int:
    """The dropout generator's seed for global step ``step`` (0-based) of
    ``epoch``."""
    return int(np.random.SeedSequence([seed, epoch, step]).generate_state(
        1)[0])


class Trainer:
    def __init__(self, cfg: Optional[Config] = None,
                 eval_hook: Optional[Callable] = None, device="cuda"):
        self.cfg = cfg or Config()
        t = self.cfg.train
        self.device = resolve_device(device)
        if t.per_replica_bn:
            raise _not_ported("per-replica BatchNorm (train.per_replica_bn)",
                              "bn_groups and multi-process training")
        self.pack = load_param_pack()
        self.model = SynergyNet(
            arch=self.cfg.model.arch,
            dtype=getattr(torch, self.cfg.model.compute_dtype)
        ).to(self.device)
        self.dataset = build_dataset(self.cfg)
        self.loader = PrefetchLoader(
            self.dataset, t.batch_size, shuffle=True, drop_last=True,
            num_workers=t.num_workers, seed=t.seed)
        steps_per_epoch = max(len(self.loader), 1)
        self.lr_fn = lr_per_step(t.base_lr, t.milestones, t.warmup,
                                 steps_per_epoch)
        self.optimizer = make_optimizer(
            self.lr_fn, momentum=t.momentum, nesterov=t.nesterov,
            weight_decay=t.weight_decay)
        init = torch.Generator(device=self.device).manual_seed(t.seed)
        self.state = create_train_state(self.model, init, self.optimizer)
        self.step_fn = make_train_step(self.pack, self.optimizer,
                                       accum_steps=t.accum_steps,
                                       device=self.device)
        self.dropout = torch.Generator(device=self.device)
        self.eval_hook = eval_hook
        self.start_epoch = 1
        if t.resume:
            self.resume(t.resume)

    # -- checkpointing ----------------------------------------------------
    def ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.cfg.train.snapshot_dir,
                            f"synergynet_epoch_{epoch}.npz")

    def save(self, epoch: int) -> str:
        path = self.ckpt_path(epoch)
        save_checkpoint(path, self.state.tree(), step=int(self.state.step),
                        metadata={"epoch": epoch,
                                  "arch": self.cfg.model.arch})
        log.info("Save checkpoint to %s", path)
        return path

    def emergency_save(self, last_epoch: int) -> None:
        """Persist the live state so a crashed run can resume."""
        path = os.path.join(self.cfg.train.snapshot_dir,
                            "synergynet_emergency.npz")
        try:
            save_checkpoint(path, self.state.tree(),
                            step=int(self.state.step),
                            metadata={"epoch": last_epoch,
                                      "emergency": True,
                                      "arch": self.cfg.model.arch})
            log.error("training failed; emergency checkpoint at %s", path)
        except Exception:
            log.exception("emergency checkpoint failed")

    def resume(self, path: str) -> None:
        self.state.load_tree(restore_checkpoint(path, self.state.tree()))
        self.start_epoch = int(checkpoint_metadata(path).get("epoch", 0)) + 1
        log.info("Resumed from %s (epoch %d)", path, self.start_epoch - 1)

    # -- loops ------------------------------------------------------------
    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(array)
        if self.device.type == "cuda":
            x = x.pin_memory()
        return x.to(self.device, non_blocking=True)

    def train_epoch(self, epoch: int) -> MeterBank:
        t = self.cfg.train
        self.loader.set_epoch(epoch)
        bank = MeterBank()
        data_time = AverageMeter()
        batch_time = AverageMeter()
        # One read of the step counter per epoch; metrics stay on the
        # device until a print boundary (a float() is a device sync).
        start_step = int(self.state.step)
        pending = []

        def flush():
            for metrics, n, step_no in pending:
                host = {k: float(v) for k, v in metrics.items()}
                bank.update(host, n=n)
                if host.get("skipped"):
                    log.warning("[NAN case] skipped step %d", step_no)
            pending.clear()

        end = time.time()
        for i, (images, params) in enumerate(self.loader):
            data_time.update(time.time() - end)
            self.dropout.manual_seed(dropout_seed(t.seed, epoch,
                                                  start_step + i))
            self.state, metrics = self.step_fn(
                self.state, self._to_device(images),
                self._to_device(params.astype(np.float32)), self.dropout)
            pending.append((metrics, images.shape[0], start_step + i + 1))
            batch_time.update(time.time() - end)
            end = time.time()
            if i % t.print_freq == 0:
                flush()
                lr = float(self.lr_fn(int(self.state.step) - 1))
                log.info("[%d][%d/%d] LR: %.8f Time: %.3f(%.3f) %s",
                         epoch, i, len(self.loader), lr, batch_time.val,
                         batch_time.avg, bank.format())
                end = time.time()
        flush()
        return bank

    def fit(self, epochs: Optional[int] = None) -> dict:
        t = self.cfg.train
        epochs = epochs if epochs is not None else t.epochs
        if t.test_initial and self.eval_hook:
            log.info("Testing from initial")
            self.eval_hook(self)
        history = {}
        epoch = self.start_epoch
        try:
            for epoch in range(self.start_epoch, epochs + 1):
                bank = self.train_epoch(epoch)
                history[epoch] = bank.averages()
                if epoch % t.save_val_freq == 0 or epoch == epochs:
                    self.save(epoch)
                    if self.eval_hook:
                        log.info("Val[%d]", epoch)
                        history[epoch]["eval"] = self.eval_hook(self)
        except Exception:
            self.emergency_save(epoch - 1)
            raise
        return history


def make_synthetic_eval_hook(n: int = 256, seed: int = 11,
                             std: float = 130.0,
                             appearance: str = "dots") -> Callable:
    """In-train validation on the synthetic AFLW2000 pack (std=130 as the
    reference's in-training normalization, quirk Q6).

    The pack is checked when the hook is made: scoring its ground-truth
    parameters through the protocol must give ~0 NME and pose MAE, or every
    in-train eval would score against a corrupted ground truth."""
    from synergynet_tpu_torch.data import (TestTransform,
                                           make_synthetic_aflw2000)
    from synergynet_tpu_torch.evals import (benchmark_params,
                                            benchmark_pipeline)
    ep = make_synthetic_aflw2000(n, seed=seed, appearance=appearance)
    gt = benchmark_params(ep["params"], ep)
    if not (gt["nme_mean"] < 0.5 and gt["foe"]["mae_mean"] < 0.5):
        raise RuntimeError(
            "synthetic eval pack failed its GT self-check "
            f"(GT-params NME {gt['nme_mean']:.3f}%, "
            f"FOE MAE {gt['foe']['mae_mean']:.3f} deg; both should be ~0)")
    tf = TestTransform()

    def hook(trainer: Trainer) -> dict:
        r = benchmark_pipeline(trainer.model, ep, trainer.pack, std=std,
                               batch=min(128, n), transform=tf)
        log.info("%s", r["report"])
        return {"nme_mean": r["nme_mean"], "foe_mae": r["foe"]["mae_mean"]}

    return hook
