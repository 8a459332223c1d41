"""yolov7_d2_tpu_torch: the PyTorch and CUDA port of yolov7_d2_tpu.

The JAX package ``yolov7_d2_tpu`` beside it is the reference. This package
imports PyTorch, and nothing of JAX or of the JAX package; its kernels are
hand-written CUDA for Hopper (``csrc/``), each with a plain PyTorch version
beside its wrapper (``kernels/``). Ported so far: YOLOX serving
(``predictor.Predictor``), the YOLOX training step
(``engine.build_yolox_system``, ``data.device_aug.make_packed_photo_step``)
and the entry points around them, run as ``python -m
yolov7_d2_tpu_torch.train_det``, ``.demo`` and ``.train_custom_datasets``
(config tree, COCO feed, packed shards, trainer, checkpoints, COCO eval).
"""

__version__ = "0.1.0"
