"""The port's dress rehearsal: the reference's on-disk formats end to end,
through the port alone, on the CPU.

The counterpart of ``tests/test_dress_rehearsal.py``. Everything a user of
the reference brings is made from a seed: a raw Basel Face Model ``.mat``
in the ``model_refine`` layout with its whitening pickle (whose converted
pack is the full 53,215-vertex ``make_synthetic_assets(seed=5)``), a
300W-LP training tree of 32 jpg crops, and an ``aflw2000_data`` eval tree
of 16 crops written under the converted pack. Then the CLIs' own code
runs: ``convert_raw_bfm`` -> ``$SYNERGY_BFM`` -> ``python -m
synergynet_tpu_torch.cli.train --platform cpu`` for one epoch at batch 8
(4 steps) -> ``cli.evaluate --platform cpu --aflw2000-dir`` on the
written checkpoint. The report is finite, and the protocol's self-checks
hold under the converted pack: the ground-truth parameters through the
ingested tree give ~0 NME and FOE.
"""

import os
import os.path as osp
import pickle

import cv2
import numpy as np
import pytest
import scipy.io as sio
import torch

from synergynet_tpu_torch.mm3d import assets

torch.set_num_threads(2)

N_TRAIN, N_EVAL, BATCH = 32, 16, 8


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def installed_pack(tmp_path_factory, monkeypatch_module):
    """A raw BFM whose conversion is make_synthetic_assets(seed=5) (bases
    padded with columns the trim must drop, 1-based keypoints and
    triangles), converted, saved and named by $SYNERGY_BFM."""
    d = assets.make_synthetic_assets(seed=5)
    rng = np.random.default_rng(99)
    nv3 = d["w_shp"].shape[0]
    kp_vert = (d["keypoints"].reshape(-1, 3)[:, 0] // 3).astype(np.float64)
    base = tmp_path_factory.mktemp("raw_bfm")
    mat = str(base / "BFM_model_front.mat")
    sio.savemat(mat, {"model_refine": {
        "w": np.concatenate([d["w_shp"], rng.normal(0, 5, (nv3, 20))], 1),
        "w_exp": np.concatenate([d["w_exp"], rng.normal(0, 2, (nv3, 19))],
                                1),
        "mu_shape": d["u_shp"].astype(np.float64),
        "mu_exp": d["u_exp"].astype(np.float64),
        "keypoints": (kp_vert + 1.0)[None, :],
        "tri": d["tri"].astype(np.int64) + 1}})
    pkl = str(base / "param_whitening.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"param_mean": d["param_mean"],
                     "param_std": d["param_std"]}, f)
    got = assets.convert_raw_bfm(mat, param_whitening_path=pkl)
    for k in d:
        assert np.array_equal(got[k], d[k]), k
    path = str(base / "converted_bfm.npz")
    assets.save_assets_npz(path, got)
    monkeypatch_module.setenv("SYNERGY_BFM", path)
    pack = assets.load_param_pack()
    assert pack.nver == assets.NVER and pack.ntri == assets.NTRI
    return path


@pytest.fixture(scope="module")
def wlp_tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("ref_root")
    (base / "train_aug_120x120").mkdir()
    (base / "3dmm_data").mkdir()
    rng = np.random.default_rng(7)
    names = []
    for i in range(N_TRAIN):
        name = f"HELEN_image_{i:04d}_0.jpg"
        cv2.imwrite(str(base / "train_aug_120x120" / name),
                    rng.integers(0, 255, (120, 120, 3), np.uint8))
        names.append(name)
    (base / "3dmm_data" / "train_aug_120x120.list.train").write_text(
        "\n".join(names) + "\n")
    with open(base / "3dmm_data" / "param_all_norm_v201.pkl", "wb") as f:
        pickle.dump(rng.normal(0, 1, (N_TRAIN, 102)).astype(np.float32), f)
    return str(base)


@pytest.fixture(scope="module")
def aflw_tree(installed_pack, tmp_path_factory):
    """aflw2000_data written from the protocol pack generated under the
    converted BFM (lossless pngs, so the ground truth round-trips)."""
    from synergynet_tpu_torch.data import make_synthetic_aflw2000
    sp = make_synthetic_aflw2000(N_EVAL, seed=21, device="cpu")
    base = tmp_path_factory.mktemp("aflw") / "aflw2000_data"
    crop, ev = base / "AFLW2000-3D_crop", base / "eval"
    crop.mkdir(parents=True)
    ev.mkdir()
    names = [f"image{i:05d}.png" for i in range(N_EVAL)]
    for name, img in zip(names, sp["images"]):
        cv2.imwrite(str(crop / name), img)
    (base / "AFLW2000-3D_crop.list").write_text("\n".join(names) + "\n")
    np.save(ev / "AFLW2000-3D.pose.npy", sp["yaws"])
    np.save(ev / "AFLW2000-3D.pts68.npy", sp["pts68_gt"])
    np.save(ev / "AFLW2000-3D-Reannotated.pts68.npy", sp["pts68_gt"])
    np.save(ev / "AFLW2000-3D_crop.roi_box.npy", sp["roi_boxes"])
    np.save(ev / "ALFW2000-3D_pose_3ANG_excl.npy", sp["pose_gt_pyr"])
    np.save(ev / "ALFW2000-3D_pose_3ANG_skip.npy", sp["skip_indices"])
    return str(base), sp


def test_raw_bfm_to_train_to_eval(installed_pack, wlp_tree, aflw_tree,
                                  tmp_path):
    from synergynet_tpu_torch.cli import evaluate as cli_evaluate
    from synergynet_tpu_torch.cli import train as cli_train
    from synergynet_tpu_torch.data import load_aflw2000_dir
    from synergynet_tpu_torch.evals import benchmark_params

    assert os.environ["SYNERGY_BFM"] == installed_pack
    snap = str(tmp_path / "snapshots")
    history = cli_train.main([
        "--root", osp.join(wlp_tree, "train_aug_120x120"),
        "--filelists-train",
        osp.join(wlp_tree, "3dmm_data", "train_aug_120x120.list.train"),
        "--param-fp-train",
        osp.join(wlp_tree, "3dmm_data", "param_all_norm_v201.pkl"),
        "--epochs", "1", "--batch-size", str(BATCH), "--warmup", "1",
        "--workers", "2", "--snapshot-dir", snap, "--no-eval",
        "--log-file", str(tmp_path / "train.log"), "--platform", "cpu",
    ])
    assert np.isfinite(history[1]["loss_total"])
    ckpt = osp.join(snap, "synergynet_epoch_1.npz")
    assert osp.exists(ckpt), sorted(os.listdir(snap))

    aflw_dir, sp = aflw_tree
    r = cli_evaluate.main(["-w", ckpt, "--aflw2000-dir", aflw_dir,
                           "--batch-size", str(BATCH), "--platform", "cpu"])
    assert np.isfinite(r["nme_mean"]) and r["nme_mean"] >= 0
    assert np.isfinite(r["foe"]["mae_mean"])
    assert "Facial Alignment" in r["report"] and "Mean MAE" in r["report"]

    # the protocol's self-check under the converted pack
    g = benchmark_params(sp["params"], load_aflw2000_dir(aflw_dir))
    assert g["nme_mean"] < 1e-3
    assert g["foe"]["mae_mean"] < 1e-3
