"""Data pipeline: datasets, augmentations, the prefetching loader and the
synthetic data."""

from synergynet_tpu_torch.data.datasets import FileListDataset, ArrayDataset  # noqa: F401
from synergynet_tpu_torch.data.transforms import (  # noqa: F401
    ColorJitter, BorderOcclusion, TrainTransform, TestTransform,
    normalize_images,
)
from synergynet_tpu_torch.data.loader import PrefetchLoader  # noqa: F401
from synergynet_tpu_torch.data.synthetic import (  # noqa: F401
    make_crops_with_params, make_synthetic_aflw2000, sample_params,
)
