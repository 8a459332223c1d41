"""yolov7_d2_tpu_torch: the PyTorch and CUDA port of yolov7_d2_tpu.

The JAX package ``yolov7_d2_tpu`` beside it is the reference. This package
imports PyTorch and never JAX; its kernels are hand-written CUDA for Hopper
(``csrc/``), each with a plain PyTorch version beside its wrapper
(``kernels/``). Ported so far: YOLOX serving (``predictor.Predictor``).
"""

__version__ = "0.1.0"
