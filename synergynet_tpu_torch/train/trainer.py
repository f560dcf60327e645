"""The Trainer: epochs, meters, logging, checkpoints, in-train eval.

Counterpart of ``synergynet_tpu/train/trainer.py`` (reference
main_train.py:103-239) on one rank of a ``(data, model)`` mesh (by default
the 1x1 mesh of one process), on the card unless the caller asks for the
CPU:

- the train step of :mod:`synergynet_tpu_torch.train.step` (loss, grads,
  SGD and the NaN skip on the device);
- the reference's step-decay schedule, driven per applied update;
- ``AverageMeter`` logging, with the step's metrics read on the host only
  at print boundaries (``trainer.py:183-215``), so steps queue back to
  back on the card;
- checkpoints every ``save_val_freq`` epochs and at the end, in the JAX
  package's format, with resume and an emergency save on failure;
- an optional validation hook (:func:`make_synthetic_eval_hook`);
- over a mesh of several processes (``trainer.py:85-170``): each data row
  loads its strided shard of the dataset and feeds ``batch_size /
  n_data`` rows a step to :func:`~synergynet_tpu_torch.train.step.
  jit_train_step`, BatchNorm is global or, with ``per_replica_bn``, each
  rank's own; the mesh's cliques are warmed first, the state is
  broadcast from rank 0 (also after ``resume``) and only rank 0 writes
  checkpoints.

Without a 300W-LP filelist the Trainer trains on the synthetic dataset
(``data.appearance``: dots or shaded), streamed per index above 100,000
crops or with ``data.streaming``. With ``data.device_augment`` the host
ships uint8 crops untouched and the step augments them on the device
(:func:`build_augment`). The head's dropout draws from a generator seeded
from ``(seed, epoch, step)``, as the JAX step folds its key
(``trainer.py:181``, ``step.py:108``), and the augmentation from
``(seed, epoch, step, 7)``; data rows after the first add their row to
both. :mod:`synergynet_tpu_torch.train.resident`
drives the same state through device-resident epochs.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from synergynet_tpu_torch.core import mesh as meshlib
from synergynet_tpu_torch.core.checkpoint import (checkpoint_metadata,
                                                  restore_checkpoint,
                                                  save_checkpoint)
from synergynet_tpu_torch.core.config import Config
from synergynet_tpu_torch.data import (ArrayDataset, FileListDataset,
                                       GeneratedCropDataset, PrefetchLoader,
                                       TrainTransform, make_crops_with_params)
from synergynet_tpu_torch.data.device_augment import device_augment
from synergynet_tpu_torch.mm3d import load_param_pack
from synergynet_tpu_torch.nn import SynergyNet
from synergynet_tpu_torch.parallel import warm_mesh_cliques
from synergynet_tpu_torch.train.meters import AverageMeter, MeterBank
from synergynet_tpu_torch.train.schedule import lr_per_step
from synergynet_tpu_torch.train.step import (create_train_state,
                                             jit_train_step, make_optimizer)

log = logging.getLogger("synergynet_tpu_torch.train")


def build_dataset(cfg: Config, device="cuda"):
    """The training dataset of ``cfg``; synthetic crops are decoded and
    rendered on ``device`` (the Trainer's), materialized or streamed."""
    d = cfg.data
    transform = (None if d.device_augment
                 else TrainTransform(d.jitter, d.border, d.occlusion_prob))
    if d.filelists_train and os.path.exists(d.filelists_train):
        return FileListDataset(d.root, d.filelists_train, d.param_fp_train,
                               transform=transform)
    log.info("no 300W-LP filelist configured; using synthetic dataset "
             "(%d crops)", d.synthetic_size)
    if d.synthetic_size > 100_000 or d.streaming:
        # The 300W-LP scale cannot be held (~29 GB at 680K crops): stream
        # crops made per index instead.
        return GeneratedCropDataset(d.synthetic_size, seed=cfg.train.seed,
                                    transform=transform,
                                    appearance=d.appearance, device=device)
    syn = make_crops_with_params(d.synthetic_size, seed=cfg.train.seed,
                                 appearance=d.appearance, device=device)
    return ArrayDataset(syn["images"], syn["params"], transform=transform)


def build_augment(cfg: Config) -> Optional[Callable]:
    """The device-side augmentation for a config, or None: one
    construction point for the host-loop and resident training paths."""
    if not cfg.data.device_augment:
        return None
    d = cfg.data
    return functools.partial(device_augment, jitter=tuple(d.jitter),
                             border=d.border,
                             occlusion_prob=d.occlusion_prob)


def _seed(words) -> int:
    return int(np.random.SeedSequence(words).generate_state(1)[0])


def dropout_seed(seed: int, epoch: int, step: int, row: int = 0) -> int:
    """The dropout generator's seed for global step ``step`` (0-based) of
    ``epoch`` on data row ``row`` of a mesh."""
    return _seed([seed, epoch, step] + ([0, row] if row else []))


def augment_seed(seed: int, epoch: int, step: int, row: int = 0) -> int:
    """The augmentation's seed for global step ``step`` of ``epoch`` on data
    row ``row``: a stream apart from the dropout's, as the JAX step folds 7
    in."""
    return _seed([seed, epoch, step, 7] + ([row] if row else []))


class Trainer:
    """``mesh``: this rank's place in a multi-process job
    (:func:`~synergynet_tpu_torch.core.mesh.make_mesh`); its device is the
    Trainer's. Without one, the 1x1 mesh on ``device``."""

    def __init__(self, cfg: Optional[Config] = None,
                 eval_hook: Optional[Callable] = None, device="cuda",
                 mesh=None):
        self.cfg = cfg or Config()
        t = self.cfg.train
        self.mesh = mesh if mesh is not None else meshlib.make_mesh(
            device=device)
        self.device = self.mesh.device
        n_data = self.mesh.shape[meshlib.DATA_AXIS]
        if t.batch_size % n_data:
            raise ValueError(f"global batch {t.batch_size} must divide over "
                             f"the mesh's {n_data} data rows")
        warm_mesh_cliques(self.mesh)
        self.pack = load_param_pack()
        self.model = SynergyNet(
            arch=self.cfg.model.arch,
            dtype=getattr(torch, self.cfg.model.compute_dtype)
        ).to(self.device)
        self.dataset = build_dataset(self.cfg, self.device)
        self.loader = PrefetchLoader(
            self.dataset, t.batch_size // n_data, shuffle=True,
            drop_last=True, num_workers=t.num_workers, seed=t.seed,
            process_index=self.mesh.data_index, process_count=n_data)
        self.steps_per_epoch = max(len(self.loader), 1)
        self.lr_fn = lr_per_step(t.base_lr, t.milestones, t.warmup,
                                 self.steps_per_epoch)
        self.optimizer = make_optimizer(
            self.lr_fn, momentum=t.momentum, nesterov=t.nesterov,
            weight_decay=t.weight_decay)
        init = torch.Generator(device=self.device).manual_seed(t.seed)
        self.state = create_train_state(self.model, init, self.optimizer)
        self.augment = build_augment(self.cfg)
        self.bn_groups = n_data if t.per_replica_bn else 1
        self.step_fn = jit_train_step(self.pack, self.optimizer, self.mesh,
                                      augment=self.augment,
                                      bn_groups=self.bn_groups,
                                      accum_steps=t.accum_steps)
        meshlib.replicate(self.mesh, self.state)
        self.dropout = torch.Generator(device=self.device)
        self.eval_hook = eval_hook
        self.start_epoch = 1
        if t.resume:
            self.resume(t.resume)

    # -- checkpointing ----------------------------------------------------
    def ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.cfg.train.snapshot_dir,
                            f"synergynet_epoch_{epoch}.npz")

    def save(self, epoch: int) -> Optional[str]:
        """Write the epoch's checkpoint (rank 0 only; None elsewhere)."""
        if self.mesh.rank != 0:
            return None
        path = self.ckpt_path(epoch)
        save_checkpoint(path, self.state.tree(), step=int(self.state.step),
                        metadata={"epoch": epoch,
                                  "arch": self.cfg.model.arch})
        log.info("Save checkpoint to %s", path)
        return path

    def emergency_save(self, last_epoch: int) -> None:
        """Persist the live state so a crashed run can resume (rank 0)."""
        if self.mesh.rank != 0:
            return
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
        meshlib.replicate(self.mesh, self.state)
        self.start_epoch = int(checkpoint_metadata(path).get("epoch", 0)) + 1
        log.info("Resumed from %s (epoch %d)", path, self.start_epoch - 1)

    # -- loops ------------------------------------------------------------
    def augment_seed(self, epoch: int, step: int) -> Optional[int]:
        """The device augmentation's seed for global step ``step``, or None
        without ``data.device_augment``."""
        if self.augment is None:
            return None
        row = self.mesh.data_index
        return augment_seed(self.cfg.train.seed, epoch, step,
                            *((row,) if row else ()))

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
            self.dropout.manual_seed(dropout_seed(
                t.seed, epoch, start_step + i, self.mesh.data_index))
            self.state, metrics = self.step_fn(
                self.state, self._to_device(images),
                self._to_device(params.astype(np.float32)), self.dropout,
                self.augment_seed(epoch, start_step + i))
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
                             appearance: str = "dots",
                             device="cuda") -> Callable:
    """In-train validation on the synthetic AFLW2000 pack (std=130 as the
    reference's in-training normalization, quirk Q6), made on ``device``.

    The pack is checked when the hook is made: scoring its ground-truth
    parameters through the protocol must give ~0 NME and pose MAE, or every
    in-train eval would score against a corrupted ground truth."""
    from synergynet_tpu_torch.data import (TestTransform,
                                           make_synthetic_aflw2000)
    from synergynet_tpu_torch.evals import (benchmark_params,
                                            benchmark_pipeline)
    ep = make_synthetic_aflw2000(n, seed=seed, appearance=appearance,
                                 device=device)
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
