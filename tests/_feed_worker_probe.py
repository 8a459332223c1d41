"""A picklable mapper factory for the loader workers of
``tests/test_torch_port_feed_rest.py``: each sample gains whether its
worker process had imported ``jax`` and had created a CUDA context. It
imports neither itself."""

import sys

import numpy as np


class ProbeFactory:
    def __init__(self, inner):
        self.inner = inner

    def __call__(self, worker_id: int):
        mapper = self.inner(worker_id)

        def probe(record):
            sample = mapper(record)
            torch = sys.modules.get("torch")
            sample["worker_jax"] = np.asarray("jax" in sys.modules)
            sample["worker_cuda"] = np.asarray(
                torch is not None and torch.cuda.is_initialized())
            return sample

        return probe
