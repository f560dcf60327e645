"""Neural network modules: every backbone family, SynergyNet and the
reference checkpoint importer (``nn.torch_import``)."""

from synergynet_tpu_torch.nn.synergy import (  # noqa: F401
    SynergyNet, synergy_criterion, init_synergy_, init_synergy_variables,
    LOSS_WEIGHTS, REFINE_SCALE,
)
from synergynet_tpu_torch.nn.backbones import (  # noqa: F401
    make_backbone, register_backbone, available_backbones,
)
from synergynet_tpu_torch.nn.pointnet import (  # noqa: F401
    MLPFor, MLPRev, PointEncoder,
)
from synergynet_tpu_torch.nn.heads import ParamHead  # noqa: F401
