"""Data pipeline: datasets, augmentations, the prefetching loader, the
synthetic data and the reference layouts' ingest."""

from synergynet_tpu_torch.data.datasets import FileListDataset, ArrayDataset  # noqa: F401
from synergynet_tpu_torch.data.transforms import (  # noqa: F401
    ColorJitter, BorderOcclusion, TrainTransform, TestTransform,
    normalize_images,
)
from synergynet_tpu_torch.data.loader import PrefetchLoader  # noqa: F401
from synergynet_tpu_torch.data.synthetic import (  # noqa: F401
    GeneratedCropDataset, make_crops_with_params, make_synthetic_aflw2000,
    sample_params,
)
from synergynet_tpu_torch.data.device_augment import device_augment  # noqa: F401
from synergynet_tpu_torch.data.ingest import (  # noqa: F401
    load_aflw2000_dir, load_300wlp_dir, save_eval_pack,
)
