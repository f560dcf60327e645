"""Shared plumbing: the config tree, the (data, model) mesh, checkpoints
and the shipped weights, profiling, file locations, the device rule of the
entry points and the optional image libraries."""

from synergynet_tpu_torch.core.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, make_mesh, batch_sharding, replicated,
    vertex_sharding, shard_batch, replicate,
)
from synergynet_tpu_torch.core.config import (  # noqa: F401
    Config, ModelConfig, TrainConfig, DataConfig, EvalConfig, DetectConfig,
    RenderConfig,
)
from synergynet_tpu_torch.core.checkpoint import (  # noqa: F401
    save_checkpoint, restore_checkpoint, checkpoint_metadata,
    load_trained_variables, load_shipped_trained, shipped_trained_path,
)
from synergynet_tpu_torch.core.profiling import (  # noqa: F401
    trace, annotate, recorder, StageTimer, device_memory_stats,
)
