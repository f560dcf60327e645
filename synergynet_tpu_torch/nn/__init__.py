"""Neural network modules: every backbone family, SynergyNet and the
reference checkpoint importer (``nn.torch_import``)."""

from synergynet_tpu_torch.nn.synergy import SynergyNet  # noqa: F401
from synergynet_tpu_torch.nn.backbones import (  # noqa: F401
    make_backbone, available_backbones,
)
from synergynet_tpu_torch.nn.heads import ParamHead  # noqa: F401
