"""Evaluation CLI, the port's ``python -m synergynet_tpu_torch.cli.evaluate``.

Counterpart of ``synergynet_tpu/cli/evaluate.py`` (the reference's
``benchmark.py``) with the same flags: the AFLW2000-3D protocol (NME by
yaw bin and the FOE MAE, reference benchmark.py:218-239) on a checkpoint
-- ``-w`` takes a framework ``.npz`` (either package's, the shipped asset
included) or a reference ``.pth.tar`` -- over a reference-layout
``--aflw2000-dir``, a pack saved by ``--save-npz`` (``--aflw2000-npz``),
or, without either, the synthetic protocol pack of ``-n`` samples.
Without ``-w`` the regressor is flax's init drawn from
``torch.Generator().manual_seed(0)``, the same distribution as the JAX
CLI's ``PRNGKey(0)`` init but not the same draws. The regressor runs in
f32 with TF32 off
(:func:`synergynet_tpu_torch.evals.make_param_extractor`), on the card
unless ``--platform cpu`` asks for the CPU. ``main`` prints the report and
returns the JAX CLI's dict. ``--aflw2000-dir`` and ``--dump-viz`` read and
write images with cv2; the rest needs neither cv2 nor matplotlib.
"""

from __future__ import annotations

import argparse
import os

from synergynet_tpu_torch.cli.train import PLATFORMS


def main(argv=None):
    p = argparse.ArgumentParser(description="SynergyNet evaluation (PyTorch)")
    p.add_argument("-w", "--weights", default=None,
                   help=".npz (framework) or .pth.tar (reference) checkpoint")
    p.add_argument("--arch", default="mobilenet_v2")
    p.add_argument("--aflw2000-npz", default=None)
    p.add_argument("--aflw2000-dir", default=None, metavar="DIR",
                   help="reference-layout aflw2000_data directory "
                        "(AFLW2000-3D_crop + .list + eval/*.npy; "
                        "reference benchmark.py:222-227)")
    p.add_argument("--reannotated", action="store_true",
                   help="use the re-annotated 68-pt GT (calc_nme option "
                        "'re', reference benchmark_aflw2000.py:108)")
    p.add_argument("--save-npz", default=None, metavar="PATH",
                   help="persist the ingested eval pack for fast re-runs")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--std", type=float, default=128.0,
                   help="normalization std (reference: 128 standalone)")
    p.add_argument("-n", "--synthetic-size", type=int, default=512)
    p.add_argument("--dump-viz", default=None, metavar="DIR",
                   help="write landmark overlays for the first 50 crops "
                        "(reference benchmark.py:168-176)")
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="device to evaluate on (default: the CUDA card)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from synergynet_tpu_torch.convert import synergy_state_dict
    from synergynet_tpu_torch.core.device import resolve_device
    from synergynet_tpu_torch.data import TestTransform
    from synergynet_tpu_torch.evals import benchmark_pipeline
    from synergynet_tpu_torch.nn import SynergyNet, init_synergy_variables

    device = resolve_device(PLATFORMS[args.platform or "cuda"])
    model = SynergyNet(arch=args.arch)
    if args.weights:
        from synergynet_tpu_torch.nn.torch_import import \
            load_synergynet_variables
        variables = load_synergynet_variables(args.weights, arch=args.arch)
        model.load_state_dict(synergy_state_dict(variables))
    else:
        init_synergy_variables(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()

    if args.aflw2000_dir:
        from synergynet_tpu_torch.data import (load_aflw2000_dir,
                                               save_eval_pack)
        eval_pack = load_aflw2000_dir(args.aflw2000_dir,
                                      reannotated=args.reannotated)
        if args.save_npz:
            save_eval_pack(eval_pack, args.save_npz)
            print(f"saved eval pack to {args.save_npz}")
    elif args.aflw2000_npz:
        with np.load(args.aflw2000_npz) as z:
            eval_pack = {k: z[k] for k in z.files}
    else:
        from synergynet_tpu_torch.data import make_synthetic_aflw2000
        eval_pack = make_synthetic_aflw2000(args.synthetic_size,
                                            device=device)

    r = benchmark_pipeline(model, eval_pack, std=args.std,
                           batch=args.batch_size, transform=TestTransform())
    print(r["report"])

    if args.dump_viz:
        from synergynet_tpu_torch.core.optional import import_cv2
        from synergynet_tpu_torch.evals import make_param_extractor
        from synergynet_tpu_torch.mm3d import (decode_landmarks,
                                               load_param_pack)
        cv2 = import_cv2("--dump-viz")
        os.makedirs(args.dump_viz, exist_ok=True)
        imgs = eval_pack["images"][:50]
        params = make_param_extractor(model, std=args.std,
                                      batch=min(64, len(imgs)))(imgs)
        with torch.no_grad():
            lmk = decode_landmarks(torch.from_numpy(params),
                                   load_param_pack()).numpy()
        for i, img in enumerate(imgs):
            canvas = np.ascontiguousarray(img)
            for x, y in zip(lmk[i, 0], lmk[i, 1]):
                cv2.circle(canvas, (int(round(x)), int(round(y))), 1,
                           (0, 255, 0), -1)
            cv2.imwrite(os.path.join(args.dump_viz, f"{i:04d}.jpg"), canvas)
        print(f"wrote {len(imgs)} landmark visualizations to {args.dump_viz}")
    return r


if __name__ == "__main__":
    main()
