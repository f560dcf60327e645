"""Ingestion of the reference's on-disk data layouts.

Counterpart of ``synergynet_tpu/data/ingest.py``, numpy only; cv2 is
imported only where a crop image is read (:func:`load_crop_images`).

The reference consumes two directory trees verbatim:

- **AFLW2000-3D eval** (reference benchmark.py:222-227,
  benchmark_aflw2000.py:13-19): ``aflw2000_data/AFLW2000-3D_crop/`` holding
  120x120 pre-cropped jpgs listed in ``AFLW2000-3D_crop.list``, plus an
  ``eval/`` directory of preprocessed ground-truth arrays (the yaw list,
  original and re-annotated 68-point landmarks, the crop boxes, and the
  FOE ground truth ``ALFW2000-3D_pose_3ANG_excl.npy`` / ``..._skip.npy`` --
  the reference's misspelling of ALFW is part of the layout).
- **300W-LP training** (reference train_script.sh:12-22,
  utils/ddfa.py:249-267): ``train_aug_120x120/`` crops listed in
  ``3dmm_data/train_aug_120x120.list.train`` with whitened parameter
  vectors in ``3dmm_data/param_all_norm_v201.pkl``.

Either tree becomes the port's in-memory structures in one call: the eval
pack of :func:`synergynet_tpu_torch.evals.benchmark_pipeline`, or a
:class:`synergynet_tpu_torch.data.FileListDataset`. Missing FOE files
degrade as in the JAX package: skip indices derive from the yaw rule
(:func:`synergynet_tpu_torch.evals.foe.derive_skip_indices`) and the FOE
report is left out when the excluded-pose array is absent.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Dict, Optional

import numpy as np

from synergynet_tpu_torch.core.optional import import_cv2

AFLW2000_CROP_DIR = "AFLW2000-3D_crop"
AFLW2000_CROP_LIST = "AFLW2000-3D_crop.list"
AFLW2000_EVAL_FILES = {
    "yaws": "AFLW2000-3D.pose.npy",
    "pts68_ori": "AFLW2000-3D.pts68.npy",
    "pts68_re": "AFLW2000-3D-Reannotated.pts68.npy",
    "roi_boxes": "AFLW2000-3D_crop.roi_box.npy",
    "pose_gt_pyr": "ALFW2000-3D_pose_3ANG_excl.npy",   # sic (reference)
    "skip_indices": "ALFW2000-3D_pose_3ANG_skip.npy",  # sic (reference)
}


def load_reference_array(path: str) -> np.ndarray:
    """The reference's ``_load`` (utils/io.py:22-30): .npy through numpy
    (allowing the pickled-object .npy files 3DDFA ships), else pickle.
    Unpickling runs code from the file: load only trusted data."""
    if path.endswith(".npy"):
        return np.load(path, allow_pickle=True)
    with open(path, "rb") as f:
        return pickle.load(f)


def read_filelist(path: str) -> list:
    """The reference datasets' filelist (utils/ddfa.py:252): the whole
    text, stripped, split on newlines."""
    with open(path) as f:
        return f.read().strip().split("\n")


def load_crop_images(root: str, names: list) -> np.ndarray:
    """120x120 crops as the reference's img_loader reads them
    (utils/ddfa.py:16-17: cv2.imread -> BGR uint8 HWC); another size is
    resized to 120x120."""
    cv2 = import_cv2("load_crop_images")
    imgs = np.empty((len(names), 120, 120, 3), np.uint8)
    for i, name in enumerate(names):
        img = cv2.imread(osp.join(root, name), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(osp.join(root, name))
        if img.shape[:2] != (120, 120):
            img = cv2.resize(img, (120, 120))
        imgs[i] = img
    return imgs


def load_aflw2000_dir(base: str, *, reannotated: bool = False,
                      load_images: bool = True,
                      limit: Optional[int] = None) -> Dict[str, np.ndarray]:
    """``aflw2000_data``-layout directory -> eval pack for
    :func:`synergynet_tpu_torch.evals.benchmark_pipeline`.

    ``reannotated`` selects the re-annotated 68-point ground truth (the
    reference's ``calc_nme(..., option='re')``, benchmark_aflw2000.py:108).
    ``limit`` keeps the first N samples and drops the FOE ground truth,
    which covers the whole set.
    """
    list_fp = osp.join(base, AFLW2000_CROP_LIST)
    crop_root = osp.join(base, AFLW2000_CROP_DIR)
    if not osp.isdir(crop_root) or not osp.isfile(list_fp):
        # The reference's guard (benchmark.py:226-227).
        raise RuntimeError(
            f"check if the testing data exist: {crop_root}, {list_fp}")
    names = read_filelist(list_fp)

    d = osp.join(base, "eval")
    pts_key = "pts68_re" if reannotated else "pts68_ori"
    pts68 = np.stack([np.asarray(p, np.float32) for p in
                      load_reference_array(
                          osp.join(d, AFLW2000_EVAL_FILES[pts_key]))])
    yaws = np.asarray(
        load_reference_array(osp.join(d, AFLW2000_EVAL_FILES["yaws"])),
        np.float32).reshape(-1)
    roi = np.asarray(
        load_reference_array(osp.join(d, AFLW2000_EVAL_FILES["roi_boxes"])),
        np.float32)

    skip_fp = osp.join(d, AFLW2000_EVAL_FILES["skip_indices"])
    if osp.isfile(skip_fp):
        skip = np.asarray(load_reference_array(skip_fp),
                          np.int64).reshape(-1)
    else:
        from synergynet_tpu_torch.evals.foe import derive_skip_indices
        skip = derive_skip_indices(yaws)

    excl_fp = osp.join(d, AFLW2000_EVAL_FILES["pose_gt_pyr"])
    pose_gt = (np.asarray(load_reference_array(excl_fp), np.float64)
               if osp.isfile(excl_fp) else None)

    n = len(names) if limit is None else min(limit, len(names))
    pack = {
        "pts68_gt": pts68[:n],
        "roi_boxes": roi[:n],
        "yaws": yaws[:n],
        "skip_indices": skip[skip < n],
    }
    if pose_gt is not None and limit is None:
        pack["pose_gt_pyr"] = pose_gt
    if load_images:
        pack["images"] = load_crop_images(crop_root, names[:n])
    return pack


def save_eval_pack(pack: Dict[str, np.ndarray], out_path: str) -> str:
    """Write an eval pack as the one .npz that the evaluation CLI's
    ``--aflw2000-npz`` reads (a one-time conversion for fast re-runs)."""
    np.savez_compressed(out_path, **pack)
    return out_path


def load_300wlp_dir(base: str, transform=None):
    """Reference-repo-root training layout -> :class:`FileListDataset`.

    Expects ``base/train_aug_120x120/`` (train_script.sh:22),
    ``base/3dmm_data/train_aug_120x120.list.train`` (:21) and
    ``base/3dmm_data/param_all_norm_v201.pkl`` (:12).
    """
    from synergynet_tpu_torch.data.datasets import FileListDataset

    root = osp.join(base, "train_aug_120x120")
    filelists = osp.join(base, "3dmm_data", "train_aug_120x120.list.train")
    param_fp = osp.join(base, "3dmm_data", "param_all_norm_v201.pkl")
    for p in (root, filelists, param_fp):
        if not os.path.exists(p):
            raise RuntimeError(f"300W-LP layout incomplete: missing {p}")
    return FileListDataset(root, filelists, param_fp, transform=transform)
