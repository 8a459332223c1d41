from yolov7_d2_tpu_torch.ops.iou import (  # noqa: F401
    bbox_overlaps_cxcywh,
    elementwise_box_iou,
    iou_loss,
    pairwise_box_iou,
    pairwise_generalized_box_iou,
)
from yolov7_d2_tpu_torch.ops.losses import (  # noqa: F401
    dfl_expectation,
    dice_loss,
    dice_score,
    distribution_focal_loss,
    l1_loss,
    masked_mean,
    quality_focal_loss,
    sigmoid_binary_cross_entropy,
    sigmoid_focal_loss,
    smooth_l1_loss,
    softmax_cross_entropy,
    weighted_softmax_cross_entropy,
)
from yolov7_d2_tpu_torch.ops.nms import (  # noqa: F401
    batched_nms,
    batched_nms_batched,
    cluster_nms,
    generalized_batched_nms,
    matrix_nms_masks,
    nms,
    nms_batched,
    soft_nms,
    weighted_boxes_fusion,
)
