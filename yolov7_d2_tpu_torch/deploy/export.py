"""The serving artifact (JAX ``deploy/export.py``).

The JAX package serializes the jitted inference function as StableHLO
(``jax.export``). The port's artifact is a ``torch.export`` program: the
graph of ATen ops with the weights in it, saved as one ``.pt2`` file and
loaded without the Python model. The NMS kernel is a node of the graph
(the custom op ``yolov7_d2_tpu_torch::nms_batched`` of
``kernels/nms.py``), so a program with the postprocess fused in launches it
on the card. Autocast regions stay autocast regions: a bf16 model exports
as a bf16 program.

``export_package`` compiles a program with AOTInductor into a package that
libtorch loads and runs without Python, the counterpart of JAX
``export_mlir``: the native client ``deploy/cc/aoti_infer.cpp`` (built by
``deploy/cc_build.py``) serves it, with the NMS op defined in C++.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn


class _Program(nn.Module):
    """``fn`` as a module (``torch.export`` takes modules); tensors it
    closes over become the program's constants."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn_or_module, example_args: Tuple, path: str
            ) -> torch.export.ExportedProgram:
    module = (fn_or_module if isinstance(fn_or_module, nn.Module)
              else _Program(fn_or_module))
    program = torch.export.export(module, tuple(example_args))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    return program


def export_program(fn_or_module, example_args: Tuple, path: str) -> str:
    """``torch.export.export`` of ``fn_or_module`` (a module, or a function
    of tensors) at the shapes and devices of ``example_args``, saved to
    ``path`` (JAX ``export_stablehlo`` :21). Returns ``path``."""
    _export(fn_or_module, example_args, path)
    return path


# Inductor's cache while it compiles a package (its generated sources,
# compiled objects and Triton's kernels): under build/ at the repository
# root
INDUCTOR_CACHE = Path(__file__).resolve().parents[2] / "build" / "inductor"


def export_package(program: torch.export.ExportedProgram,
                   out_dir: str) -> str:
    """``program`` compiled by AOTInductor
    (``torch._inductor.aoti_compile_and_package``) for the device of its
    example inputs, written to ``out_dir/model_aoti.pt2`` (JAX
    ``export_mlir`` :49). Returns the path."""
    from torch._inductor import aoti_compile_and_package
    from torch._inductor.runtime.cache_dir_utils import temporary_cache_dir

    os.makedirs(out_dir, exist_ok=True)
    with temporary_cache_dir(str(INDUCTOR_CACHE)):
        return aoti_compile_and_package(
            program, package_path=os.path.join(out_dir, "model_aoti.pt2"))


def load_program(path: str) -> torch.export.ExportedProgram:
    """The program saved at ``path`` (JAX ``load_stablehlo`` :41); call
    ``.module()(*args)`` to run it. The kernels module is imported first,
    so that the NMS op is registered in a fresh process."""
    from yolov7_d2_tpu_torch.kernels import nms  # noqa: F401

    return torch.export.load(path)


class InferenceModule(nn.Module):
    """``model`` in eval mode on a float32 NHWC batch, then ``postprocess``
    of its outputs where given."""

    def __init__(self, model: nn.Module, postprocess: Optional[Callable]
                 = None):
        super().__init__()
        self.model = model.eval()
        self.postprocess = postprocess

    def forward(self, images: torch.Tensor):
        out = self.model(images)
        return out if self.postprocess is None else self.postprocess(out)


def export_inference_fn(model: nn.Module,
                        input_shape: Tuple[int, int, int, int], out_dir: str,
                        postprocess: Optional[Callable] = None,
                        package: bool = False) -> Dict[str, str]:
    """Export ``model`` (and ``postprocess`` of its outputs, fused in) on a
    float32 NHWC batch of ``input_shape`` on the model's device, the
    weights in the artifact, as ``out_dir/model.pt2``, and write
    ``out_dir/export_meta.json`` with the JAX package's keys (JAX :75);
    with ``package``, also ``export_package`` of the program. Returns the
    paths: "program", "meta" (and "package")."""
    os.makedirs(out_dir, exist_ok=True)
    device = next(model.parameters()).device
    example = torch.zeros(tuple(input_shape), dtype=torch.float32,
                          device=device)
    path = os.path.join(out_dir, "model.pt2")
    program = _export(InferenceModule(model, postprocess), (example,), path)
    meta = {
        "input_shape": list(input_shape),
        "input_dtype": "float32",
        "layout": "NHWC",
        "postprocess_fused": postprocess is not None,
    }
    meta_path = os.path.join(out_dir, "export_meta.json")
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    paths = {"program": path, "meta": meta_path}
    if package:
        paths["package"] = export_package(program, out_dir)
    return paths


def conv_dtypes(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """{dtype name: count} of the convolutions' outputs in ``program``, its
    autocast regions included: a bf16 model's program convolves in
    bfloat16."""
    counts: Dict[str, int] = {}
    for gm in program.graph_module.modules():
        graph = getattr(gm, "graph", None)
        if graph is None:
            continue
        for node in graph.nodes:
            if node.op == "call_function" and "conv" in str(node.target):
                val = node.meta.get("val")
                key = str(getattr(val, "dtype", None)).replace("torch.", "")
                counts[key] = counts.get(key, 0) + 1
    return counts
