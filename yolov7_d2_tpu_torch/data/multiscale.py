"""Multi-scale training (JAX ``data/multiscale.py``).

The reference changes the training input size every 10 iterations and
broadcasts the choice across ranks (``meta_arch/yolo.py:131-146``). Here,
as in the JAX package, the size is a deterministic function of the step
over a small set of sizes, so every rank computes the same one and nothing
is broadcast. ``train/trainer.MultiScaleHook`` advances the wrapper's
step.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def size_for_step(step: int, sizes: Sequence[Tuple[int, int]],
                  interval: int = 10, seed: int = 0) -> Tuple[int, int]:
    """A size of ``sizes`` drawn from a numpy generator seeded with ``seed
    + step // interval``: constant within ``interval`` steps (JAX :21)."""
    rng = np.random.default_rng(seed + step // interval)
    return tuple(sizes[int(rng.integers(0, len(sizes)))])


class MultiScaleMapperWrapper:
    """A mapper whose ``input_size`` follows :func:`size_for_step` at
    ``self.step`` (JAX :34), which the trainer advances. A batch is of one
    size where one mapper maps it in order."""

    def __init__(self, mapper, sizes: Sequence[Tuple[int, int]],
                 interval: int = 10, seed: int = 0):
        self.mapper = mapper
        self.sizes = [tuple(s) for s in sizes]
        self.interval = interval
        self.seed = seed
        self.step = 0

    def __call__(self, record: dict) -> Dict[str, np.ndarray]:
        self.mapper.input_size = size_for_step(self.step, self.sizes,
                                               self.interval, self.seed)
        return self.mapper(record)


def default_size_set(base: int = 640, span: int = 5,
                     stride: int = 32) -> List[Tuple[int, int]]:
    """The square sizes ``base`` +- ``span`` strides (JAX :59)."""
    return [(base + i * stride, base + i * stride)
            for i in range(-span, span + 1)]
