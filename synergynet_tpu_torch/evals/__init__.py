"""Evaluation harness: AFLW2000-3D NME by yaw bins + face-orientation MAE."""

from synergynet_tpu_torch.evals.nme import (  # noqa: F401
    calc_nme, analyze_by_yaw, format_nme_report,
)
from synergynet_tpu_torch.evals.foe import foe_mae, format_foe_report  # noqa: F401
from synergynet_tpu_torch.evals.benchmark import (  # noqa: F401
    make_param_extractor, benchmark_params, benchmark_pipeline,
)
