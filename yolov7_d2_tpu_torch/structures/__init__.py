from yolov7_d2_tpu_torch.structures.boxes import (  # noqa: F401
    BoxMode,
    box_area,
    clip_boxes,
    convert_box_mode,
    cxcywh_to_xyxy,
    scale_boxes,
    xywh_corner_to_xyxy,
    xyxy_to_cxcywh,
    xyxy_to_xywh_corner,
)
from yolov7_d2_tpu_torch.structures.instances import (  # noqa: F401
    Detections,
    GtInstances,
)
