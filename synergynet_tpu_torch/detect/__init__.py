"""Face detection: FaceBoxes net (folded s2d8), anchors, NMS, detector."""

from synergynet_tpu_torch.detect.anchors import (  # noqa: F401
    generate_anchors, num_anchors, decode_boxes, STEPS, MIN_SIZES, VARIANCES,
)
from synergynet_tpu_torch.detect.nms import (  # noqa: F401
    greedy_nms_mask, nms_indices, pairwise_iou, soft_nms, soft_nms_device,
)
from synergynet_tpu_torch.detect.net import FaceBoxesNet  # noqa: F401
from synergynet_tpu_torch.detect.detector import (  # noqa: F401
    FaceBoxes, load_faceboxes_variables, select_detections,
)
