"""The port's configuration. ``YoloxConfig`` (``config/yolox.py``) is what
the model, the training step and serving read; the entry points merge the
yaml files of ``configs/`` into ``config/defaults.get_cfg()`` (a
``CfgNode``, which needs PyYAML) and turn it into a ``YoloxConfig`` with
``YoloxConfig.from_cfg``. Only ``YoloxConfig`` is imported here, so that
serving needs no PyYAML."""

from yolov7_d2_tpu_torch.config.yolox import YoloxConfig  # noqa: F401
