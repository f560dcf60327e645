"""Shared plumbing: the config tree, checkpoints and the shipped weights,
file locations, the device rule of the entry points and the optional
image libraries."""

from synergynet_tpu_torch.core.config import (  # noqa: F401
    Config, ModelConfig, TrainConfig, DataConfig, EvalConfig, DetectConfig,
    RenderConfig,
)
from synergynet_tpu_torch.core.checkpoint import (  # noqa: F401
    save_checkpoint, restore_checkpoint, checkpoint_metadata,
    load_trained_variables, load_shipped_trained, shipped_trained_path,
)
