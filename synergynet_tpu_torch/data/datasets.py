"""Datasets: 300W-LP-style filelist datasets + in-memory arrays.

A copy of ``synergynet_tpu/data/datasets.py``. cv2 is imported only when
a file is read, and its absence raises an error that says so (the card's
machine has no cv2; the synthetic in-memory data needs none).

Equivalents of the reference's ``DDFADataset`` / ``DDFATestDataset``
(reference utils/ddfa.py:249-294): a text filelist of crop images rooted at
``root`` plus a pickled array of whitened >=62-d parameter vectors, truncated
to 62 at batch time like the reference training loop (main_train.py:120).
Images load as BGR uint8 HWC via cv2, exactly the reference's loader
(utils/ddfa.py:16-17).
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Optional

import numpy as np

from synergynet_tpu_torch.core.optional import import_cv2


def _load_params(param_fp: str) -> np.ndarray:
    if param_fp.endswith(".npz"):
        z = np.load(param_fp)
        return np.asarray(z[z.files[0]], np.float32)
    if param_fp.endswith(".npy"):
        return np.asarray(np.load(param_fp), np.float32)
    with open(param_fp, "rb") as f:
        return np.asarray(pickle.load(f), np.float32)


class FileListDataset:
    """(img_u8 HWC BGR, param62 f32) samples from a filelist + param file."""

    def __init__(self, root: str, filelists: str,
                 param_fp: Optional[str] = None,
                 transform: Optional[Callable] = None):
        self.root = root
        with open(filelists) as f:
            self.lines = f.read().strip().split("\n")
        self.params = (None if param_fp is None
                       else _load_params(param_fp))
        if self.params is not None and len(self.params) < len(self.lines):
            raise ValueError(
                f"{len(self.lines)} files but {len(self.params)} params")
        self.transform = transform

    def __len__(self) -> int:
        return len(self.lines)

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None):
        cv2 = import_cv2("FileListDataset")
        img = cv2.imread(os.path.join(self.root, self.lines[index]),
                         cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(self.lines[index])
        if self.transform is not None:
            img = self.transform(img, rng)
        if self.params is None:
            return img
        return img, self.params[index][:62]


class ArrayDataset:
    """In-memory (images (N,H,W,3) uint8, params (N,>=62)) dataset."""

    def __init__(self, images: np.ndarray,
                 params: Optional[np.ndarray] = None,
                 transform: Optional[Callable] = None):
        self.images = images
        self.params = params
        self.transform = transform

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None):
        img = self.images[index]
        if self.transform is not None:
            img = self.transform(img, rng)
        if self.params is None:
            return img
        return img, self.params[index][:62]
