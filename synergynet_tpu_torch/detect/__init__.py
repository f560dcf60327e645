"""Face detection: FaceBoxes net (every topology), anchors, NMS, detector,
the reference checkpoint importer, and detector training."""

from synergynet_tpu_torch.detect.anchors import (  # noqa: F401
    generate_anchors, num_anchors, decode_boxes, STEPS, MIN_SIZES, VARIANCES,
)
from synergynet_tpu_torch.detect.nms import (  # noqa: F401
    greedy_nms_mask, nms_indices, pairwise_iou, soft_nms, soft_nms_device,
)
from synergynet_tpu_torch.detect.net import FaceBoxesNet  # noqa: F401
from synergynet_tpu_torch.detect.detector import (  # noqa: F401
    FaceBoxes, select_detections,
)
from synergynet_tpu_torch.detect.torch_import import (  # noqa: F401
    convert_torch_state_dict, load_faceboxes_variables,
)
from synergynet_tpu_torch.detect.train_utils import (  # noqa: F401
    jaccard, encode, match, multibox_loss, center_to_corner,
)
from synergynet_tpu_torch.detect.trainer import (  # noqa: F401
    DetectorTrainer, make_synthetic_detection_batch,
)
