"""The port stands without JAX: every slice module imports in a process
where ``import jax`` fails, and no port source names jax. Its entry points
run on the card unless the caller asks for the CPU."""

import inspect
import os
import re
import subprocess
import sys

import pytest
import torch

import synergynet_tpu_torch

torch.set_num_threads(2)

PKG = os.path.dirname(synergynet_tpu_torch.__file__)

MODULES = [
    "synergynet_tpu_torch",
    "synergynet_tpu_torch.core.paths",
    "synergynet_tpu_torch.core.device",
    "synergynet_tpu_torch.core.checkpoint",
    "synergynet_tpu_torch.core.profiling",
    "synergynet_tpu_torch.mm3d",
    "synergynet_tpu_torch.ops",
    "synergynet_tpu_torch.ops.cuda_build",
    "synergynet_tpu_torch.nn",
    "synergynet_tpu_torch.convert",
    "synergynet_tpu_torch.detect",
    "synergynet_tpu_torch.detect.stem_fused",
    "synergynet_tpu_torch.pipeline",
    "synergynet_tpu_torch.pipeline.overlay_engine",
    "synergynet_tpu_torch.pipeline.outputs",
    "synergynet_tpu_torch.mm3d.crop",
    "synergynet_tpu_torch.ops.resize",
    "synergynet_tpu_torch.render",
    "synergynet_tpu_torch.render.overlay",
    "synergynet_tpu_torch.render.texture",
    "synergynet_tpu_torch.losses",
    "synergynet_tpu_torch.nn.batchnorm",
    "synergynet_tpu_torch.nn.pointnet",
    "synergynet_tpu_torch.core.config",
    "synergynet_tpu_torch.train",
    "synergynet_tpu_torch.train.step",
    "synergynet_tpu_torch.train.schedule",
    "synergynet_tpu_torch.train.meters",
    "synergynet_tpu_torch.train.trainer",
    "synergynet_tpu_torch.data",
    "synergynet_tpu_torch.data.transforms",
    "synergynet_tpu_torch.data.datasets",
    "synergynet_tpu_torch.data.loader",
    "synergynet_tpu_torch.data.synthetic",
    "synergynet_tpu_torch.data.keyed",
    "synergynet_tpu_torch.data.shaded",
    "synergynet_tpu_torch.data.device_augment",
    "synergynet_tpu_torch.train.resident",
    "synergynet_tpu_torch.evals",
    "synergynet_tpu_torch.evals.nme",
    "synergynet_tpu_torch.evals.foe",
    "synergynet_tpu_torch.evals.benchmark",
    "synergynet_tpu_torch.cli.train",
]


def test_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['flax'] = None\n"
            "sys.modules['synergynet_tpu'] = None\n"
            "sys.modules['optax'] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.dirname(PKG)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("root", ["synergynet_tpu_torch", "chip_smoke.py"])
def test_no_jax_import_in_sources(root):
    path = os.path.join(os.path.dirname(PKG), root)
    files = ([path] if path.endswith(".py") else
             [os.path.join(d, f) for d, _, fs in os.walk(path)
              for f in fs if f.endswith(".py")])
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|synergynet_tpu)\b", re.M)
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_entry_points_default_to_the_card(monkeypatch):
    import numpy as np
    from synergynet_tpu_torch.detect import FaceBoxes, nms_indices, soft_nms
    from synergynet_tpu_torch.pipeline import (SynergyNet3DMM, prepare_frame,
                                               preprocess_crops)
    from synergynet_tpu_torch.render import (RenderPipeline, rasterize,
                                             rasterize_buffers,
                                             rasterize_texture_buffers,
                                             rasterize_tiled,
                                             rasterize_triangles,
                                             render_overlay, render_texture)
    for fn in (SynergyNet3DMM, FaceBoxes, prepare_frame, preprocess_crops,
               nms_indices, soft_nms, RenderPipeline, rasterize, rasterize_buffers,
               rasterize_tiled, rasterize_triangles, render_texture,
               rasterize_texture_buffers):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # With no card, asking for one raises instead of running on the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = torch.zeros((16, 16, 3), dtype=torch.uint8).numpy()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        prepare_frame(img, 8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        FaceBoxes()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SynergyNet3DMM(variables="trained")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SynergyNet3DMM()
    roi = [np.array([0.0, 0.0, 8.0, 8.0])]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        preprocess_crops(img, roi)
    for fn in (nms_indices, soft_nms):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            fn(np.ones((2, 5), np.float32))
    verts = np.asarray([[1, 1, 1], [9, 1, 1], [1, 9, 1]], np.float32)
    tris = np.asarray([[0, 1, 2]], np.int32)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        RenderPipeline()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        render_overlay(img, [verts.T], tris.T)
    for fn in (rasterize, rasterize_tiled):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            fn(verts, tris, verts, bg=img)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rasterize_buffers(verts, tris, verts, h=16, w=16)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rasterize_triangles(verts, tris, h=16, w=16)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        render_texture(verts, tris, verts[:, :2], img, img)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rasterize_texture_buffers(verts, tris, verts[:, :2], img, h=16, w=16)
    canvas, _, _, _ = prepare_frame(img, 8, device="cpu")
    assert canvas.device.type == "cpu"
    assert rasterize(verts, tris, verts, bg=img, device="cpu").shape == \
        img.shape


@pytest.mark.parametrize("flags", [(True, True), (False, True),
                                   (True, False)])
def test_full_fp32_turns_tf32_off_and_restores(flags):
    from synergynet_tpu_torch.mm3d.codec import full_fp32
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        with full_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == flags
        with pytest.raises(ZeroDivisionError), full_fp32():
            1 / 0
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == flags
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_training_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from synergynet_tpu_torch.cli import train as cli
    from synergynet_tpu_torch.core.config import Config
    from synergynet_tpu_torch.mm3d import load_param_pack
    from synergynet_tpu_torch.data import (GeneratedCropDataset,
                                           make_crops_with_params,
                                           make_synthetic_aflw2000)
    from synergynet_tpu_torch.data.shaded import make_shaded_crops
    from synergynet_tpu_torch.train import (Trainer, make_optimizer,
                                            make_synthetic_eval_hook,
                                            make_train_step)
    from synergynet_tpu_torch.train.trainer import build_dataset
    data = (make_crops_with_params, make_synthetic_aflw2000,
            make_shaded_crops, GeneratedCropDataset)
    for fn in (Trainer, make_train_step, make_synthetic_eval_hook,
               build_dataset) + data:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_train_step(load_param_pack(), make_optimizer(lambda c: 0.1))
    for fn in data:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            fn(4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_synthetic_eval_hook(n=4)
    cfg = Config()
    cfg.data.synthetic_size = 16
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(cfg)
    import logging
    try:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli.main(["--no-eval", "--synthetic-size", "16",
                      "--log-file", str(tmp_path / "log")])
    finally:
        for h in list(logging.getLogger().handlers):
            logging.getLogger().removeHandler(h)
            h.close()


@pytest.mark.parametrize("streaming", [False, True])
def test_trainer_makes_its_data_on_its_device(monkeypatch, streaming):
    """The Trainer's shaded crops, materialized or streamed, are rendered
    on the Trainer's device, never on a default of their own."""
    import numpy as np
    from synergynet_tpu_torch.core.config import Config
    from synergynet_tpu_torch.data import shaded
    from synergynet_tpu_torch.train import Trainer
    seen = []
    real = shaded.render_chunked

    def spy(lmk, idx, key, device):
        seen.append(torch.device(device))
        return real(lmk, idx, key, device)
    monkeypatch.setattr(shaded, "render_chunked", spy)
    cfg = Config()
    cfg.data.synthetic_size = 8
    cfg.data.appearance = "shaded"
    cfg.data.streaming = streaming
    cfg.train.batch_size = 4
    tr = Trainer(cfg, device="cpu")
    if streaming:
        assert tr.dataset.device == tr.device
        images, _ = tr.dataset.fetch_batch(np.arange(4))
        assert images.shape == (4, 120, 120, 3)
    assert seen and all(d == tr.device for d in seen)


def test_bare_cuda_resolves_to_the_current_card(monkeypatch):
    """A bare "cuda" names the current card's index, the device a tensor
    moved there reports, so the Trainer's state and step devices agree."""
    from synergynet_tpu_torch.core.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device(torch.device("cuda")) == torch.device("cuda", 3)
    assert resolve_device("cpu") == torch.device("cpu")
