"""The port's anchor-YOLO training step against the JAX package, in
float32 on the CPU: train-mode losses and parameter gradients of YOLOV7,
YOLO and YOLOV7P (the trajectory through ``build_system`` is in
``tests/test_torch_port_yolov7.py``).

Models at reduced depth (one block a Darknet stage, ``_torch_port_helpers.
ANCHOR_ARCHS``), 64 px. Tolerances, each with its reason:

* losses after the whole model: 1e-4 relative, the forward's tolerance;
  ``num_fg`` exact (the targets do not depend on the predictions);
* parameter gradients (train-mode BatchNorm) of YOLOV7 and YOLOV7P (SiLU
  and mish): 1e-3 of each tensor's largest magnitude plus 1e-6 of the
  model's largest gradient, as for YOLOX (``tests/test_torch_port_train.
  py``); measured against a float64 run of the port, the JAX float32
  gradients are up to 3.4e-4 of their tensor away, the port's 1.5e-4
  (YOLOV7; YOLOV7P, measured at 128 px with its builder's PAFPN width
  1.0, 2.0e-4 and 1.5e-4). YOLO (leaky ReLU): the
  whole gradient within 1e-1 of its norm, each tensor within 2.5e-1 of its
  norm. Its float32 gradient jumps at the kink: an element whose
  pre-activation rounds to the other side of 0 takes the other slope, and
  train-mode BatchNorm spreads that over its channel. Measured over three
  weight draws on this scene, the whole gradient of each package is
  0.7-6% (of its norm) from a float64 run of the port and 1.1-6% from the
  other, single tensors up to 47% of their largest element (ROADMAP.md
  C.7); a dropped or mis-signed term moves its tensors by 100% or more;
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (
    ANCHOR_CLASSES,
    anchor_yolo_name_mapper,
    anchor_yolo_pair,
)
from yolov7_d2_tpu.models.meta_arch import yolov7 as jarch
from yolov7_d2_tpu_torch.config import AnchorYoloConfig
from yolov7_d2_tpu_torch.models.meta_arch import yolov7 as tarch

MODEL_LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
LRELU_GRAD_RTOL = 1e-1
LRELU_TENSOR_RTOL = 2.5e-1
ANCHORS = np.array(AnchorYoloConfig.anchors, np.float32)
LOSS_KW = {
    # each architecture's loss as build_system wires it from its yaml;
    # YOLOV7P with the ratio target builder, which no yaml selects
    "YOLOV7": dict(variant="yolov7", build_target_type="default",
                   iou_type="ciou", loss_type="v7", ignore_threshold=0.5),
    "YOLO": dict(variant="yolov3", build_target_type="default",
                 iou_type="ciou", loss_type="v4", ignore_threshold=0.5),
    "YOLOV7P": dict(variant="yolov7", build_target_type="yolov5",
                    iou_type="ciou", loss_type="v7", ignore_threshold=0.5),
}


def _gts(rng, b, size, g, n_valid):
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(n_valid):
        wh = rng.uniform(0.15, 0.8, (n, 2)) * size
        c = rng.uniform(wh / 2, size - wh / 2)
        boxes[i, :n] = np.concatenate([c - wh / 2, c + wh / 2], -1)
        valid[i, :n] = True
    classes = (rng.integers(0, ANCHOR_CLASSES, (b, g)) * valid).astype(
        np.int32)
    return boxes, classes, valid


@functools.lru_cache(maxsize=None)
def _pair(arch):
    return anchor_yolo_pair(arch, seed=1)


def _flax_path(mapper, module_name, param_name, module):
    leaf = {"weight": ("scale" if isinstance(module, torch.nn.BatchNorm2d)
                       else "kernel"), "bias": "bias"}[param_name]
    return mapper(module_name) + (leaf,)


@pytest.mark.parametrize("arch", sorted(LOSS_KW))
def test_train_losses_and_param_grads_match_jax(arch):
    jmodel, variables, tmodel, _ = _pair(arch)
    rng = np.random.default_rng(12)
    images = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    gts = _gts(rng, 2, 64, 8, [6, 3])
    batch = dict(zip(("gt_boxes", "gt_classes", "gt_valid"), gts))
    kw = LOSS_KW[arch]

    def loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        losses = jarch.anchor_yolo_loss_fn(
            out, {k: jnp.asarray(v) for k, v in batch.items()}, ANCHORS,
            ANCHOR_CLASSES, **kw)
        return losses["total_loss"], losses

    jgrads, jlosses = jax.jit(jax.grad(loss, has_aux=True))(
        variables["params"])

    tmodel.train()
    tmodel.zero_grad()
    losses = tarch.anchor_yolo_loss_fn(
        tmodel(torch.from_numpy(images)),
        {k: torch.from_numpy(v) for k, v in batch.items()}, ANCHORS,
        ANCHOR_CLASSES, **kw)
    losses["total_loss"].backward()
    tmodel.eval()
    assert float(losses["num_fg"]) == float(jlosses["num_fg"]) > 3
    for k in ("loss_box", "loss_obj", "loss_cls", "total_loss"):
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=MODEL_LOSS_RTOL,
                                   err_msg=k)

    flat = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jgrads)}
    mapper = anchor_yolo_name_mapper(arch)
    pairs = []
    for mname, module in tmodel.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            want = flat.pop(_flax_path(mapper, mname, pname, module))
            if want.ndim == 4:
                want = want.transpose(3, 2, 0, 1)
            pairs.append((f"{mname}.{pname}", p.grad.numpy(), want))
    assert not flat, list(flat)[:5]
    if arch == "YOLO":
        # norms: the kinks of leaky ReLU (see the module docstring)
        got = np.concatenate([g.ravel() for _, g, _ in pairs])
        want = np.concatenate([w.ravel() for _, _, w in pairs])
        whole = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert whole <= LRELU_GRAD_RTOL, whole
        norm, rtol = np.linalg.norm, LRELU_TENSOR_RTOL
    else:
        norm, rtol = (lambda a: float(np.abs(a).max())), GRAD_RTOL
    top = max(norm(w) for _, _, w in pairs)
    worst = 0.0
    for name, got, want in pairs:
        scale, err = norm(want), norm(got - want)
        worst = max(worst, err / max(scale, 1e-30))
        assert err <= rtol * scale + 1e-6 * top, \
            f"{name}: {err:.3g} of {scale:.3g}"
    print(f"{arch}: worst gradient error, relative to its tensor: "
          f"{worst:.2e}")
