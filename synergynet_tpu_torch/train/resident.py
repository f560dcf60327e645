"""Device-resident training: the dataset on the card, the host out of the
step loop.

Counterpart of ``synergynet_tpu/train/resident.py`` on one rank of a
``(data, model)`` mesh (D data rows; D = 1 in one process). A host loader
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
- Over a mesh each data row holds its ``n / D`` rows
  (:func:`shard_resident_arrays`, :func:`shard_resident_params`), draws its
  own order (row 0 as one process does, row ``r`` with ``r`` appended to
  the seed words) and feeds ``batch_size / D`` rows a step to the mesh's
  step (:func:`make_epoch_program`, :func:`make_generative_epoch_program`).

The step metrics add up on the device and the host reads them once per
epoch; nothing else in an epoch waits for the card. Checkpoints, the eval
hook, the history and the emergency save follow ``Trainer.fit``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from synergynet_tpu_torch.core import mesh as meshlib
from synergynet_tpu_torch.data import keyed
from synergynet_tpu_torch.data.shaded import render_shaded_crops
from synergynet_tpu_torch.train.step import jit_train_step
from synergynet_tpu_torch.train.trainer import augment_seed, dropout_seed

# The render key's last word: the generative epoch's lighting and
# background stream, apart from the materialized crops' (one-word) keys.
RENDER_STREAM = 1


def epoch_metrics(sums: Dict[str, torch.Tensor], steps: int
                  ) -> Dict[str, float]:
    """Per-epoch means of the step metrics: the epoch's one host read."""
    keys = sorted(sums)
    values = torch.stack([sums[k] for k in keys]).cpu().tolist()
    return {k: v / steps for k, v in zip(keys, values)}


def _row_words(words, row: int):
    return list(words) + ([row] if row else [])


def _check_steps(trainer, n: int) -> int:
    """The epoch's steps for ``n`` crops over the Trainer's mesh; they must
    be the steps its learning-rate schedule counts."""
    b = trainer.cfg.train.batch_size
    d = trainer.mesh.shape[meshlib.DATA_AXIS]
    steps = d * (n // d) // b
    if steps != trainer.steps_per_epoch:
        raise ValueError(
            f"{n} crops make {steps} steps of {b}, but the Trainer's "
            f"learning-rate schedule counts {trainer.steps_per_epoch} steps "
            "an epoch: build the Trainer on a dataset of the same size")
    return steps


def _drive_epochs(trainer, epochs: Optional[int], log_fn,
                  run_epoch: Callable) -> Dict[int, dict]:
    """The epoch loop of ``Trainer.fit`` around ``run_epoch(epoch, step0)
    -> (host metrics, steps)``: the step counter is read once, before the
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
            host, steps = run_epoch(epoch, step)
            step += steps
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


def epoch_permutation(seed: int, epoch: int, n: int, device,
                      row: int = 0) -> torch.Tensor:
    """The resident epoch's order of data row ``row``'s n crops: a
    permutation drawn on ``device`` from a generator seeded by ``(seed,
    epoch)`` (and the row after the first)."""
    g = torch.Generator(device=device).manual_seed(int(
        np.random.SeedSequence(_row_words([seed, epoch, 2 ** 31], row)
                               ).generate_state(1)[0]))
    return torch.randperm(n, generator=g, device=device)


def generative_order(seed: int, epoch: int, n: int, row: int = 0
                     ) -> np.ndarray:
    """The generative epoch's order of data row ``row``'s n parameters,
    drawn on the host from ``SeedSequence([seed, epoch])`` (and the row
    after the first)."""
    return np.random.default_rng(np.random.SeedSequence(
        _row_words([seed, epoch], row))).permutation(n)


def _epoch_runner(step_fn, mesh, batch_size: int, seed: int,
                  augment: bool, batch_of: Callable, order_of: Callable):
    """``epoch(state, epoch, step0) -> (state, host metrics)``: the steps
    over this data row's order, seeded as ``Trainer.train_epoch`` seeds
    them; ``batch_of(idx, epoch)`` gives a step's (images, params62)."""
    d = mesh.shape[meshlib.DATA_AXIS]
    if batch_size % d:
        raise ValueError(f"batch {batch_size} not divisible by data={d}")
    bl, row = batch_size // d, mesh.data_index
    gen = torch.Generator(device=mesh.device)

    def epoch(state, ep: int, step0: int = 0):
        perm, n_local = order_of(ep)
        steps = d * n_local // batch_size
        sums = None
        for i in range(steps):
            images, target62 = batch_of(perm[i * bl:(i + 1) * bl], ep)
            gen.manual_seed(dropout_seed(seed, ep, step0 + i, row))
            state, m = step_fn(state, images, target62, gen,
                               augment_seed(seed, ep, step0 + i, row)
                               if augment else None)
            sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
        return state, epoch_metrics(sums, steps)

    return epoch


def make_epoch_program(pack, optimizer, mesh, batch_size: int,
                       augment: Optional[Callable] = None,
                       bn_groups: int = 1, accum_steps: int = 1,
                       seed: int = 0, step_fn: Optional[Callable] = None):
    """``epoch(state, images, params62, epoch, step0=0) -> (state,
    metrics)``: one resident epoch on this rank of ``mesh``. ``images``
    (n_local, H, W, 3) uint8 and ``params62`` (n_local, 62) are the data
    row's resident rows (:func:`shard_resident_arrays`); each step gathers
    ``batch_size / D`` of them in the row's order
    (:func:`epoch_permutation`) and runs the mesh's step
    (``step_fn``, else :func:`~synergynet_tpu_torch.train.step.
    jit_train_step` of the arguments). ``metrics``: the epoch's means of
    the step metrics, read on the host once."""
    step_fn = step_fn or jit_train_step(pack, optimizer, mesh, augment,
                                        bn_groups, accum_steps)
    row = mesh.data_index

    def epoch(state, images, params62, ep: int, step0: int = 0):
        run = _epoch_runner(
            step_fn, mesh, batch_size, seed, augment is not None,
            lambda idx, _: (images.index_select(0, idx),
                            params62.index_select(0, idx)),
            lambda e: (epoch_permutation(seed, e, len(images),
                                         images.device, row),
                       len(images)))
        return run(state, ep, step0)

    return epoch


def make_generative_epoch_program(pack, optimizer, mesh, batch_size: int,
                                  augment: Optional[Callable] = None,
                                  bn_groups: int = 1, accum_steps: int = 1,
                                  seed: int = 0,
                                  step_fn: Optional[Callable] = None):
    """``epoch(state, params62, epoch, step0=0) -> (state, metrics)``: one
    device-generative epoch on this rank of ``mesh``. Only ``params62``
    (n_local, 62), the data row's rows (:func:`shard_resident_params`),
    are resident; each step renders its crops on the device
    (:func:`generative_batch`), keyed by the crop's global index
    ``row * n_local + i``, in the row's host-drawn order
    (:func:`generative_order`)."""
    step_fn = step_fn or jit_train_step(pack, optimizer, mesh, augment,
                                        bn_groups, accum_steps)
    row, dev = mesh.data_index, mesh.device
    render_pack = pack._replace(u=pack.u[:0], w_shp=pack.w_shp[:0],
                                w_exp=pack.w_exp[:0]).to(dev)

    def epoch(state, params62, ep: int, step0: int = 0):
        n_local = len(params62)

        def order(e):
            perm = torch.from_numpy(generative_order(seed, e, n_local, row))
            if dev.type == "cuda":
                perm = perm.pin_memory()
            return perm.to(dev, non_blocking=True), n_local

        run = _epoch_runner(
            step_fn, mesh, batch_size, seed, augment is not None,
            lambda idx, e: generative_batch(params62, idx, render_pack,
                                            seed, e, idx + row * n_local),
            order)
        return run(state, ep, step0)

    return epoch


def _local_rows(mesh, n: int) -> slice:
    d = mesh.shape[meshlib.DATA_AXIS]
    nl = n // d
    return slice(mesh.data_index * nl, (mesh.data_index + 1) * nl)


def shard_resident_arrays(mesh, images: np.ndarray, params62: np.ndarray
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Tuple[int, ...]]:
    """Upload this data row's block of (n, H, W, 3) crops and (n, 62)
    parameters (``n // D`` rows; the last ``n % D`` crops go unused) to
    the rank's device once. Returns them and the per-crop (H, W, C)."""
    sl = _local_rows(mesh, len(images))
    return (torch.from_numpy(np.ascontiguousarray(images[sl])).to(
                mesh.device),
            torch.from_numpy(np.asarray(params62[sl], np.float32)).to(
                mesh.device),
            tuple(images.shape[1:]))


def shard_resident_params(mesh, params62: np.ndarray) -> torch.Tensor:
    """Upload only this data row's block of the (n, 62) whitened
    parameters: the generative path's whole resident dataset."""
    sl = _local_rows(mesh, len(params62))
    return torch.from_numpy(np.asarray(params62[sl], np.float32)).to(
        mesh.device)


def fit_resident(trainer, images: np.ndarray, params62: np.ndarray,
                 epochs: Optional[int] = None,
                 log_fn: Optional[Callable] = None) -> Dict[int, dict]:
    """Train ``trainer``'s state on (n, H, W, 3) uint8 ``images`` and their
    (n, 62) ``params62``: each data row's block uploaded once to its
    device, one on-device permutation per epoch, ``n // batch_size`` steps
    an epoch. Returns the history as ``Trainer.fit`` does."""
    t = trainer.cfg.train
    steps = _check_steps(trainer, len(images))
    g_imgs, g_tgts, _ = shard_resident_arrays(trainer.mesh, images,
                                              params62)
    epoch_fn = make_epoch_program(
        trainer.pack, trainer.optimizer, trainer.mesh, t.batch_size,
        augment=trainer.augment, seed=t.seed, step_fn=trainer.step_fn)

    def run_epoch(epoch, step0):
        trainer.state, host = epoch_fn(trainer.state, g_imgs, g_tgts, epoch,
                                       step0)
        return host, steps

    return _drive_epochs(trainer, epochs, log_fn, run_epoch)


def generative_batch(params62: torch.Tensor, idx: torch.Tensor, pack,
                     seed: int, epoch: int,
                     key_idx: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images, params62) of the crops ``idx`` (indices into ``params62``,
    on its device) for ``epoch``: their parameters gathered and their crops
    rendered on the device, keyed by ``(seed, epoch, RENDER_STREAM)`` and
    the crop's global index ``key_idx`` (``idx`` by default)."""
    target = params62.index_select(0, idx)
    key = keyed.make_key(seed, epoch, RENDER_STREAM)
    with torch.no_grad():
        return render_shaded_crops(target, pack, key,
                                   idx if key_idx is None else key_idx
                                   ), target


def fit_resident_generative(trainer, params62: np.ndarray,
                            epochs: Optional[int] = None,
                            log_fn: Optional[Callable] = None
                            ) -> Dict[int, dict]:
    """Train on shaded crops rendered on the device every step: only each
    data row's block of the (n, 62) ``params62`` is uploaded. Returns the
    history as ``Trainer.fit`` does."""
    t = trainer.cfg.train
    steps = _check_steps(trainer, len(params62))
    g_tgts = shard_resident_params(trainer.mesh, params62)
    epoch_fn = make_generative_epoch_program(
        trainer.pack, trainer.optimizer, trainer.mesh, t.batch_size,
        augment=trainer.augment, seed=t.seed,
        step_fn=trainer.step_fn)

    def run_epoch(epoch, step0):
        trainer.state, host = epoch_fn(trainer.state, g_tgts, epoch, step0)
        return host, steps

    return _drive_epochs(trainer, epochs, log_fn, run_epoch)
