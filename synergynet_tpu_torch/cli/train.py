"""Training CLI, the port's ``python -m synergynet_tpu_torch.cli.train``.

Counterpart of ``synergynet_tpu/cli/train.py`` with the same flags (the
reference's ``main_train.py`` / ``train_script.sh``: mobilenet_v2, batch
1024, lr 0.08, 80 epochs, milestones 48,64, warmup 5, 8 workers);
``--arch`` takes any name of
:func:`synergynet_tpu_torch.nn.available_backbones`. It runs
on the card unless ``--platform cpu`` asks for the CPU. ``--resident``
uploads the whole dataset to the device once and trains device-resident
epochs (:func:`synergynet_tpu_torch.train.fit_resident`). The
multi-process flags of the JAX CLI (``--coordinator``,
``--num-processes``, ``--process-id``, ``--n-model`` > 1) are accepted
and raise ``NotImplementedError``, naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import logging
import sys

# --platform -> device, shared by every CLI of the port.
PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def main(argv=None):
    p = argparse.ArgumentParser(description="SynergyNet training (PyTorch)")
    p.add_argument("--config", default=None, help="JSON config path")
    p.add_argument("--arch", default=None,
                   help="backbone: any name of nn.available_backbones()")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--base-lr", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--milestones", default=None, help="e.g. 48,64")
    p.add_argument("--warmup", type=int, default=None)
    p.add_argument("--root", default=None)
    p.add_argument("--filelists-train", default=None)
    p.add_argument("--param-fp-train", default=None)
    p.add_argument("--synthetic-size", type=int, default=None,
                   help="synthetic dataset size when no filelist is given")
    p.add_argument("--snapshot-dir", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--accum-steps", type=int, default=None,
                   help="run each batch as N sequential microbatches "
                        "(mean of gradients, chained BN statistics)")
    p.add_argument("--test-initial", action="store_true")
    p.add_argument("--log-file", default="output.log")
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--n-model", type=int, default=1)
    p.add_argument("--resident", action="store_true",
                   help="device-resident epochs: upload the whole dataset "
                        "to the device once, one metrics read per epoch")
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="device to train on (default: the CUDA card)")
    args = p.parse_args(argv)

    for flag, set_ in (("--coordinator", args.coordinator is not None),
                       ("--num-processes", args.num_processes is not None),
                       ("--process-id", args.process_id is not None),
                       ("--n-model > 1", args.n_model > 1)):
        if set_:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP.md, queue A, item A6: "
                "bn_groups and multi-process training)")

    logging.basicConfig(
        format="[%(asctime)s] [p%(process)d] %(message)s",
        level=logging.INFO,
        handlers=[logging.FileHandler(args.log_file, mode="w"),
                  logging.StreamHandler(sys.stdout)], force=True)

    from synergynet_tpu_torch.core.config import Config
    cfg = Config.from_json(args.config) if args.config else Config()
    if args.arch:
        cfg.model.arch = args.arch
    t = cfg.train
    for name, val in (("batch_size", args.batch_size),
                      ("base_lr", args.base_lr), ("epochs", args.epochs),
                      ("warmup", args.warmup), ("resume", args.resume),
                      ("num_workers", args.workers),
                      ("accum_steps", args.accum_steps),
                      ("snapshot_dir", args.snapshot_dir)):
        if val is not None:
            setattr(t, name, val)
    if args.milestones:
        t.milestones = tuple(int(m) for m in args.milestones.split(","))
    if args.test_initial:
        t.test_initial = True
    d = cfg.data
    for name, val in (("root", args.root),
                      ("filelists_train", args.filelists_train),
                      ("param_fp_train", args.param_fp_train),
                      ("synthetic_size", args.synthetic_size)):
        if val is not None:
            setattr(d, name, val)

    logging.info("config:\n%s", cfg.to_json())
    device = PLATFORMS[args.platform or "cuda"]
    from synergynet_tpu_torch.train import Trainer, make_synthetic_eval_hook
    hook = None if args.no_eval else make_synthetic_eval_hook(device=device)
    trainer = Trainer(cfg, eval_hook=hook, device=device)
    logging.info("training on %s", trainer.device)
    if not args.resident:
        return trainer.fit()
    import numpy as np
    from synergynet_tpu_torch.train import fit_resident
    ds = trainer.dataset
    if hasattr(ds, "generate_images"):           # streaming generator
        imgs, params = ds.generate_images(np.arange(len(ds))), ds.params
    elif hasattr(ds, "images"):                  # materialized arrays
        imgs, params = np.asarray(ds.images), np.asarray(ds.params)
    else:                                        # file-backed: decode all
        pairs = [ds[i] for i in range(len(ds))]
        imgs = np.stack([p[0] for p in pairs])
        params = np.stack([p[1] for p in pairs])
    return fit_resident(trainer, imgs, params,
                        log_fn=lambda e, m: logging.info(
                            "[resident epoch %d] loss %.4f skipped %.3f",
                            e, m["loss_total"], m["skipped"]))


if __name__ == "__main__":
    main()
