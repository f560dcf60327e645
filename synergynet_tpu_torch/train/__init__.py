"""Training runtime: the step, optimizer, schedule, meters and the
Trainer."""

from synergynet_tpu_torch.train.step import (  # noqa: F401
    TrainState, make_optimizer, create_train_state, make_train_step,
)
from synergynet_tpu_torch.train.schedule import (  # noqa: F401
    step_decay_lr, lr_per_step,
)
from synergynet_tpu_torch.train.meters import AverageMeter, MeterBank  # noqa: F401
from synergynet_tpu_torch.train.trainer import (  # noqa: F401
    Trainer, build_dataset, make_synthetic_eval_hook,
)
