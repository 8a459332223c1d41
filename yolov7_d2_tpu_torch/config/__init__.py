"""The port's configuration. ``YoloxConfig`` (``config/yolox.py``) is what
the model, the training step and serving read; the entry points merge the
yaml files of ``configs/`` into ``config/defaults.get_cfg()`` (a
``CfgNode``, which needs PyYAML) and turn it into a ``YoloxConfig`` with
``YoloxConfig.from_cfg``; the anchor-based YOLO family reads its subclass
``AnchorYoloConfig`` (``config/anchor_yolo.py``), SparseInst
``SparseInstConfig`` (``config/sparseinst.py``), DETR and AnchorDETR
``DetrConfig`` (``config/detr.py``, DetrSegm too), YOLOX-KPTS
``YoloxKptsConfig`` (``config/yolox_kpts.py``), YOLOv6 and YOLOF
``Yolov6Config`` and ``YolofConfig`` (``config/onestage.py``), SOLOv2
``Solov2Config`` (``config/solov2.py``), Mask R-CNN, Faster R-CNN and
Panoptic FPN ``RcnnConfig`` (``config/rcnn.py``); YOLOMask reads
``AnchorYoloConfig``. Only the dataclasses are
imported here, so that serving needs no PyYAML."""

from yolov7_d2_tpu_torch.config.anchor_yolo import (  # noqa: F401
    AnchorYoloConfig,
)
from yolov7_d2_tpu_torch.config.detr import DetrConfig  # noqa: F401
from yolov7_d2_tpu_torch.config.onestage import (  # noqa: F401
    YolofConfig,
    Yolov6Config,
)
from yolov7_d2_tpu_torch.config.rcnn import RcnnConfig  # noqa: F401
from yolov7_d2_tpu_torch.config.solov2 import Solov2Config  # noqa: F401
from yolov7_d2_tpu_torch.config.sparseinst import (  # noqa: F401
    SparseInstConfig,
)
from yolov7_d2_tpu_torch.config.yolox import YoloxConfig  # noqa: F401
from yolov7_d2_tpu_torch.config.yolox_kpts import (  # noqa: F401
    YoloxKptsConfig,
)
