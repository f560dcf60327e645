"""Device-resident training: the dataset on the card, the host out of the
step loop.

Counterpart of ``synergynet_tpu/train/resident.py`` on one device (the
data axis D = 1; several cards come with ROADMAP item A6). A host loader
feeds the card one batch at a time; for a dataset that fits device memory
the port removes it:

- :func:`fit_resident` uploads the uint8 crops and the (n, 62) parameters
  once. Each epoch draws a permutation on the device; each step gathers
  its batch with ``index_select`` and runs the Trainer's step (the 5-term
  criterion, the device augmentation when configured, the NaN skip).
- :func:`fit_resident_generative` keeps only the parameters on the device
  (170 MB at the 680K-crop 300W-LP scale, whose crops would be 29 GB):
  each step decodes its batch's landmarks and renders its crops on the
  device (:mod:`synergynet_tpu_torch.data.shaded`), keyed by the epoch and
  the crop's index, so a crop's geometry is fixed and its lighting and
  background re-roll every epoch. The epoch's order is drawn on the host
  from ``SeedSequence([seed, epoch])`` and uploaded (8 bytes a crop).

The step metrics add up on the device and the host reads them once per
epoch; nothing else in an epoch waits for the card. Checkpoints, the eval
hook, the history and the emergency save follow ``Trainer.fit``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from synergynet_tpu_torch.data import keyed
from synergynet_tpu_torch.data.shaded import render_shaded_crops
from synergynet_tpu_torch.train.trainer import dropout_seed

# The render key's last word: the generative epoch's lighting and
# background stream, apart from the materialized crops' (one-word) keys.
RENDER_STREAM = 1


def epoch_metrics(sums: Dict[str, torch.Tensor], steps: int
                  ) -> Dict[str, float]:
    """Per-epoch means of the step metrics: the epoch's one host read."""
    keys = sorted(sums)
    values = torch.stack([sums[k] for k in keys]).cpu().tolist()
    return {k: v / steps for k, v in zip(keys, values)}


def _steps_per_epoch(trainer, n: int) -> int:
    b = trainer.cfg.train.batch_size
    if n // b != trainer.steps_per_epoch:
        raise ValueError(
            f"{n} crops make {n // b} steps of {b}, but the Trainer's "
            f"learning-rate schedule counts {trainer.steps_per_epoch} steps "
            "an epoch: build the Trainer on a dataset of the same size")
    return n // b


def _run_steps(trainer, epoch: int, step0: int,
               batches: Iterable[Tuple[torch.Tensor, torch.Tensor]]
               ) -> Dict[str, torch.Tensor]:
    """Run the Trainer's step on each (images, params62) batch, global
    steps ``step0``, ``step0 + 1``, ... of ``epoch``, seeding dropout and
    augmentation as ``Trainer.train_epoch`` does; returns the metrics'
    sums, on the device."""
    seed = trainer.cfg.train.seed
    sums = None
    for i, (images, target62) in enumerate(batches):
        trainer.dropout.manual_seed(dropout_seed(seed, epoch, step0 + i))
        trainer.state, m = trainer.step_fn(
            trainer.state, images, target62, trainer.dropout,
            trainer.augment_seed(epoch, step0 + i))
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    return sums


def _drive_epochs(trainer, epochs: Optional[int], log_fn,
                  run_epoch: Callable) -> Dict[int, dict]:
    """The epoch loop of ``Trainer.fit`` around ``run_epoch(epoch, step0)
    -> (metric sums, steps)``: the step counter is read once, before the
    first epoch, and counted on the host after."""
    t = trainer.cfg.train
    epochs = epochs if epochs is not None else t.epochs
    history: Dict[int, dict] = {}
    if t.test_initial and trainer.eval_hook:
        trainer.eval_hook(trainer)
    step = int(trainer.state.step)
    epoch = trainer.start_epoch
    try:
        for epoch in range(trainer.start_epoch, epochs + 1):
            sums, steps = run_epoch(epoch, step)
            step += steps
            host = epoch_metrics(sums, steps)
            history[epoch] = host
            if log_fn:
                log_fn(epoch, host)
            if epoch % t.save_val_freq == 0 or epoch == epochs:
                trainer.save(epoch)
                if trainer.eval_hook:
                    history[epoch]["eval"] = trainer.eval_hook(trainer)
    except Exception:
        trainer.emergency_save(epoch - 1)
        raise
    return history


def epoch_permutation(seed: int, epoch: int, n: int, device) -> torch.Tensor:
    """The resident epoch's order: a permutation of n drawn on ``device``
    from a generator seeded by ``(seed, epoch)``."""
    g = torch.Generator(device=device).manual_seed(int(
        np.random.SeedSequence([seed, epoch, 2 ** 31]).generate_state(1)[0]))
    return torch.randperm(n, generator=g, device=device)


def fit_resident(trainer, images: np.ndarray, params62: np.ndarray,
                 epochs: Optional[int] = None,
                 log_fn: Optional[Callable] = None) -> Dict[int, dict]:
    """Train ``trainer``'s state on (n, H, W, 3) uint8 ``images`` and their
    (n, 62) ``params62``, uploaded once to the Trainer's device, one
    on-device permutation per epoch; ``n // batch_size`` steps an epoch.
    Returns the history as ``Trainer.fit`` does."""
    dev = trainer.device
    b = trainer.cfg.train.batch_size
    steps = _steps_per_epoch(trainer, len(images))
    g_imgs = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
    g_tgts = torch.from_numpy(np.asarray(params62, np.float32)).to(dev)

    def run_epoch(epoch, step0):
        perm = epoch_permutation(trainer.cfg.train.seed, epoch, len(g_imgs),
                                 dev)
        batches = ((g_imgs.index_select(0, idx), g_tgts.index_select(0, idx))
                   for idx in (perm[i * b:(i + 1) * b] for i in range(steps)))
        return _run_steps(trainer, epoch, step0, batches), steps

    return _drive_epochs(trainer, epochs, log_fn, run_epoch)


def generative_batch(params62: torch.Tensor, idx: torch.Tensor, pack,
                     seed: int, epoch: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(images, params62) of the crops ``idx`` (global indices on the
    device) for ``epoch``: their parameters gathered and their crops
    rendered on the device, keyed by ``(seed, epoch, RENDER_STREAM)`` and
    the index."""
    target = params62.index_select(0, idx)
    key = keyed.make_key(seed, epoch, RENDER_STREAM)
    with torch.no_grad():
        return render_shaded_crops(target, pack, key, idx), target


def fit_resident_generative(trainer, params62: np.ndarray,
                            epochs: Optional[int] = None,
                            log_fn: Optional[Callable] = None
                            ) -> Dict[int, dict]:
    """Train on shaded crops rendered on the device every step: only the
    (n, 62) ``params62`` are uploaded. Returns the history as
    ``Trainer.fit`` does."""
    dev = trainer.device
    t = trainer.cfg.train
    b = t.batch_size
    steps = _steps_per_epoch(trainer, len(params62))
    g_tgts = torch.from_numpy(np.asarray(params62, np.float32)).to(dev)
    pack = trainer.pack._replace(u=trainer.pack.u[:0],
                                 w_shp=trainer.pack.w_shp[:0],
                                 w_exp=trainer.pack.w_exp[:0]).to(dev)

    def run_epoch(epoch, step0):
        order = np.random.default_rng(np.random.SeedSequence(
            [t.seed, epoch])).permutation(len(params62))
        perm = trainer._to_device(order)
        batches = (generative_batch(g_tgts, perm[i * b:(i + 1) * b], pack,
                                    t.seed, epoch) for i in range(steps))
        return _run_steps(trainer, epoch, step0, batches), steps

    return _drive_epochs(trainer, epochs, log_fn, run_epoch)
