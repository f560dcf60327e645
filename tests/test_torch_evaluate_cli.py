"""The port's evaluation CLI against the JAX package's, on the CPU.

Both ``main``s run on the same inputs (``--platform cpu`` for the port)
and their returned reports agree within 1e-3 (NME in percent per yaw bin,
their mean, the FOE MAE in degrees: ``test_torch_evals.py``'s tolerance),
with equal counts and report lines of the same labels:

- the synthetic protocol pack of 32 samples at batch 32 (so the dump's
  extractor compiles no second JAX program), on the shipped ``.npz``,
  with ``--dump-viz``: the drawn jpgs are equal for every crop whose 68
  landmarks round to the same pixels in both packages (the landmarks are
  read from the extractors the dumps call), at least 28 of the 32;
- a reference-layout ``aflw2000_data`` tree of 16 jpg crops with
  ``--aflw2000-dir`` and ``--save-npz``, then the port again on that file
  with ``--aflw2000-npz`` (the same report exactly), and with
  ``--reannotated``;
- a seeded reference-layout ``best.pth.tar`` (MobileNetV2) as ``-w``.
"""

import math
import os

import cv2
import numpy as np
import pytest
import torch

import synergynet_tpu.evals as jevals
import synergynet_tpu_torch.evals as tevals
from synergynet_tpu.cli import evaluate as jax_cli
from synergynet_tpu.core.checkpoint import shipped_trained_path
from synergynet_tpu.data import make_synthetic_aflw2000 as jax_aflw
from synergynet_tpu_torch.cli import evaluate as cli

torch.set_num_threads(2)

ATOL = 1e-3
N_SYNTH, BATCH = 32, 32


def _assert_reports_agree(got, want):
    for name in ("[ 0, 30]", "[30, 60]", "[60, 90]"):
        g, w = got["nme"][name], want["nme"][name]
        assert g["count"] == w["count"], name
        for k in ("mean", "std"):
            if math.isnan(w[k]):
                assert math.isnan(g[k]), (name, k)
            else:
                assert abs(g[k] - w[k]) <= ATOL, (name, k, g[k], w[k])
    assert abs(got["nme_mean"] - want["nme_mean"]) <= ATOL
    assert (got["foe"] is None) == (want["foe"] is None)
    if want["foe"] is not None:
        for k in ("mae_mean",):
            assert abs(got["foe"][k] - want["foe"][k]) <= ATOL, k
    label = [ln.split(":")[0] for ln in want["report"].splitlines()]
    assert [ln.split(":")[0] for ln in got["report"].splitlines()] == label


@pytest.fixture()
def recorded(monkeypatch):
    """The params that each package's ``evals.make_param_extractor``
    returns (the CLIs' ``--dump-viz`` calls it), by package."""
    seen = {"jax": [], "port": []}
    for key, mod in (("jax", jevals), ("port", tevals)):
        real = mod.make_param_extractor

        def wrapped(*a, _real=real, _key=key, **kw):
            extract = _real(*a, **kw)

            def run(images):
                out = np.asarray(extract(images))
                seen[_key].append(out)
                return out
            return run
        monkeypatch.setattr(mod, "make_param_extractor", wrapped)
    return seen


def test_synthetic_pack_and_dump_viz(tmp_path, recorded):
    from synergynet_tpu.mm3d import decode_landmarks as jax_decode
    from synergynet_tpu.mm3d import load_param_pack as jax_pack
    common = ["-w", shipped_trained_path(), "-n", str(N_SYNTH),
              "--batch-size", str(BATCH)]
    want = jax_cli.main(common + ["--dump-viz", str(tmp_path / "jax")])
    got = cli.main(common + ["--dump-viz", str(tmp_path / "port"),
                             "--platform", "cpu"])
    _assert_reports_agree(got, want)
    assert got["foe"] is not None and np.isfinite(got["nme_mean"])

    jax_files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == jax_files
    assert len(jax_files) == N_SYNTH
    lmk = {k: np.asarray(jax_decode(v[-1], jax_pack()))
           for k, v in recorded.items()}
    same = [i for i in range(N_SYNTH) if np.array_equal(
        np.round(lmk["jax"][i, :2]), np.round(lmk["port"][i, :2]))]
    assert len(same) >= 28, len(same)
    for i in same:
        a = cv2.imread(str(tmp_path / "jax" / f"{i:04d}.jpg"))
        b = cv2.imread(str(tmp_path / "port" / f"{i:04d}.jpg"))
        assert np.array_equal(a, b), i


@pytest.fixture(scope="module")
def aflw_dir(tmp_path_factory):
    sp = jax_aflw(16, seed=21)
    base = tmp_path_factory.mktemp("aflw") / "aflw2000_data"
    crop, ev = base / "AFLW2000-3D_crop", base / "eval"
    crop.mkdir(parents=True)
    ev.mkdir()
    names = [f"image{i:05d}.jpg" for i in range(16)]
    for name, img in zip(names, sp["images"]):
        cv2.imwrite(str(crop / name), img)
    (base / "AFLW2000-3D_crop.list").write_text("\n".join(names) + "\n")
    np.save(ev / "AFLW2000-3D.pose.npy", sp["yaws"])
    np.save(ev / "AFLW2000-3D.pts68.npy", sp["pts68_gt"])
    np.save(ev / "AFLW2000-3D-Reannotated.pts68.npy", sp["pts68_gt"] * 1.01)
    np.save(ev / "AFLW2000-3D_crop.roi_box.npy", sp["roi_boxes"])
    np.save(ev / "ALFW2000-3D_pose_3ANG_excl.npy", sp["pose_gt_pyr"])
    np.save(ev / "ALFW2000-3D_pose_3ANG_skip.npy", sp["skip_indices"])
    return str(base)


def test_aflw2000_dir_then_saved_npz(aflw_dir, tmp_path):
    common = ["-w", shipped_trained_path(), "--batch-size", str(BATCH)]
    want = jax_cli.main(common + ["--aflw2000-dir", aflw_dir])
    saved = str(tmp_path / "aflw.npz")
    got = cli.main(common + ["--aflw2000-dir", aflw_dir, "--save-npz",
                             saved, "--platform", "cpu"])
    _assert_reports_agree(got, want)
    assert got["nme"]["[ 0, 30]"]["count"] + \
        got["nme"]["[30, 60]"]["count"] + got["nme"]["[60, 90]"]["count"] \
        == 16
    again = cli.main(common + ["--aflw2000-npz", saved, "--platform", "cpu"])
    assert again["report"] == got["report"]
    assert again["foe"] == got["foe"]
    jax_again = jax_cli.main(common + ["--aflw2000-npz", saved])
    _assert_reports_agree(again, jax_again)


def test_reannotated(aflw_dir):
    common = ["-w", shipped_trained_path(), "--batch-size", str(BATCH),
              "--aflw2000-dir", aflw_dir, "--reannotated"]
    want = jax_cli.main(common)
    got = cli.main(common + ["--platform", "cpu"])
    _assert_reports_agree(got, want)
    plain = cli.main(common[:-1] + ["--platform", "cpu"])
    assert plain["nme_mean"] != got["nme_mean"]


def test_reference_pth_tar_weights(tmp_path):
    from synergynet_tpu_torch.nn.torch_import import (expected_torch_shapes,
                                                      seeded_torch_state_dict)
    sd = seeded_torch_state_dict(expected_torch_shapes("mobilenet_v2"), 7)
    path = str(tmp_path / "best.pth.tar")
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}},
               path)
    common = ["-w", path, "-n", str(N_SYNTH), "--batch-size", str(BATCH)]
    want = jax_cli.main(common)
    got = cli.main(common + ["--platform", "cpu"])
    _assert_reports_agree(got, want)


def test_platform_choices_and_the_card_default(monkeypatch):
    with pytest.raises(SystemExit):
        cli.main(["--platform", "tpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["-n", "4"])
