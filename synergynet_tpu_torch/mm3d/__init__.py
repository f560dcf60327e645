"""3DMM core: asset pack, 62-parameter codec, pose math, crop geometry."""

from synergynet_tpu_torch.mm3d.assets import (  # noqa: F401
    NVER, NTRI, N_SHP, N_EXP, N_POSE, N_PARAM, N_LMK, STD_SIZE,
    ParamPack, load_param_pack, make_synthetic_assets, pack_from_arrays,
)
from synergynet_tpu_torch.mm3d.codec import (  # noqa: F401
    dewhiten, whiten, parse_param62, decode_param62, decode_landmarks,
    decode_dense, rescale_to_roi,
)
from synergynet_tpu_torch.mm3d.pose import (  # noqa: F401
    p2srt, matrix_to_euler_deg, pose_from_param, rescale_pose_to_roi,
)
from synergynet_tpu_torch.mm3d.crop import square_box, crop_img  # noqa: F401
