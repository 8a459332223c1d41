"""JAX variables -> the port's ``state_dict``.

The inverse of ``yolov7_d2_tpu/utils/weight_port.py:port_torch_state_dict``:
for every key of the port's ``state_dict()`` the flax path comes from a
name map (``map_yolox_torch_name`` for YOLOX, ``map_anchor_yolo_torch_name``
for the anchor-YOLO family, built on copies of the JAX package's maps of
the same names), conv kernels go
``[kH, kW, I, O] -> [O, I, kH, kW]``, and BatchNorm ``scale/bias``
(params) and ``mean/var`` (batch_stats) become
``weight/bias/running_mean/running_var``, dense kernels ``[I, O] -> [O, I]``.
SparseInst (``map_sparseinst_torch_name``) and the ResNet of YOLOV7P take
copies of the JAX package's detectron2-ResNet and SparseInst maps. DETR
(``map_detr_torch_name``, a copy of the JAX map of the reference's names)
and AnchorDETR (``map_anchor_detr_torch_name``) add attention: a flax
``MultiHeadDotProductAttention`` keeps query, key and value kernels [E, H,
hd] with biases [H, hd] and an ``out`` kernel [H, hd, E]; the port's
``in_proj_weight`` [3E, E] / ``in_proj_bias`` [3E] stack the three (the
inverse of the JAX ``split_torch_mha``) and ``out_proj`` takes ``out``.
A key whose leaf is neither a weight, a bias nor a statistic (AnchorDETR's
``anchor_points``) and an embedding's ``weight`` (``query_embed``) take the
flax parameter of the same path as it is. Swin and PVTv2
(``map_swin_torch_name``, ``map_pvt_v2_torch_name``, copies of the JAX
maps) and YOLOX-KPTS (``map_yolox_kpts_torch_name``): a window attention's
``relative_position_bias_table`` takes flax's ``rel_pos_bias``, its
``relative_position_index`` (a buffer the model computes) stays as the
template holds it, and a patch merging's norm and reduction go from flax's
channel order into the reference's (``swin_merge_perm``). YOLOv6
(``map_yolov6_torch_name``: EfficientRep, RepPAN, EffiDeHead), YOLOF
(``map_yolof_torch_name``), the YOLOv5 backbone and the BiFPN and PP-YOLO
PAN necks and Res2Net / Res2NeXt (through ``map_anchor_yolo_torch_name``)
take copies of the JAX maps; a transposed convolution's kernel (RepPAN's
``upsample_transpose``) goes from flax's ``[kH, kW, I, O]`` to torch's
``[I, O, kH, kW]`` flipped
in both spatial axes (flax's ``ConvTranspose`` does not flip its kernel,
torch's ``ConvTranspose2d`` computes with the flipped one), and a BiFPN
node's ``edge_weights`` is the flax parameter ``cell{r}_fnode{i}_edge``.
The backbone zoo under the ported heads (``BACKBONE_MAPS``, by the models'
``backbone_type``): ConvNeXt and EfficientNet keep the reference's names
(``map_convnext_torch_name``, ``map_efficientnet_torch_name``, copies of
the JAX maps; ConvNeXt's layer scale ``gamma`` is the flax parameter of the
block's path), RegNet and FBNet the flax ones (``map_flax_named_torch_name``),
as FBNet under its FPN (``map_fbnet_fpn_torch_name``: the trunk is flax's
``trunk``) and MobileViT (``map_mobilevit_torch_name``: its
attentions' ``out_proj`` is flax's ``out``) do; CSPResNet50d takes the vd
ResNet's map (``map_cspresnet50d_torch_name``).
SMCA-DETR, DAB-DETR and the d2go DETR (``map_detr_variant_torch_name``)
take their backbone's map and the flax names of their transformers, heads,
``cs_head`` and per-level ``dec_norm_{i}``. Mask R-CNN and Panoptic FPN
(``map_mask_rcnn_torch_name``) keep the flax names but for the detectron2
ResNet under ``backbone.bottom_up``; ``box_fc1``'s kernel reads the pooled
features flattened as (S, S, C), which is the port's order too, and
``mask_deconv`` is a flax ``ConvTranspose``.
A deformable convolution's fuse weight keeps torch's ``[O, C, K, K]``
(detectron2's and the reference DLA's ``ModulatedDeformConv``); the JAX
package's is the 1x1 kernel over the taps ``[1, 1, K*K*C, O]``, tap-major
(``dcn_weight_to_flax`` / ``dcn_weight_from_flax``, the layout of the JAX
``port_dla_state_dict``). A ResNet DCN block keeps the flax names
(``conv2_dcn``, its ``offset_conv``, ``conv2_bn``). DLA
(``map_dla_torch_name``, a copy of the JAX map, in :data:`BACKBONE_MAPS`)
keeps the reference's names; its ``up_*`` grouped transposed convolutions
take the JAX ``BilinearUp`` kernel [k, k, 1, C] flipped spatially
(``depthwise_up_from_flax``). SOLOv2 (``map_solov2_torch_name``: the JAX
package's head maps), YOLOMask (``map_yolomask_torch_name``) and DETRsegm
(``map_detr_segm_torch_name``) map by prefix.
The flax tree is nested dicts of numpy arrays, so no JAX is needed here.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

_STATS_LEAF = {"running_mean": "mean", "running_var": "var"}


def _csp_inner(rest: str) -> str:
    """CSPLayer inner names: 'm.0.conv1.conv' -> 'm_0/conv1/conv'."""
    rest = re.sub(r"^m\.(\d+)\.", r"m_\1/", rest)
    return rest.replace(".", "/")


def map_yolox_torch_name(name: str) -> Tuple[str, ...]:
    """Translate a YOLOX state-dict key of the original reference (and of
    the port, which keeps its names), without the trailing parameter name,
    into the JAX package's flax module path parts.

    Examples:
      backbone.stem.conv.conv        -> backbone/stem/conv/conv
      backbone.dark2.0.conv          -> backbone/dark2_conv/conv
      backbone.dark2.1.conv1.conv    -> backbone/dark2_csp/conv1/conv
      backbone.dark5.1.conv1.conv    -> backbone/dark5_spp/conv1/conv
      neck.C3_p4.m.0.conv1.conv      -> neck/C3_p4/m_0/conv1/conv
      head.cls_convs.0.1.conv        -> head/cls_conv_0_1/conv
      head.cls_preds.0               -> head/cls_pred_0
      head.stems.0.conv              -> head/stem_0/conv
    """
    # backbone.stem.conv.X -> backbone/stem/conv/X
    m = re.match(r"^backbone\.stem\.(.*)$", name)
    if m:
        return tuple(f"backbone/stem/{m.group(1)}".replace(".", "/").split("/"))

    # backbone.darkN.<idx>...
    m = re.match(r"^backbone\.dark(\d)\.(\d+)\.(.*)$", name)
    if m:
        lvl, idx, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        if lvl == 5:
            part = {0: "dark5_conv", 1: "dark5_spp", 2: "dark5_csp"}[idx]
        else:
            part = {0: f"dark{lvl}_conv", 1: f"dark{lvl}_csp"}[idx]
        return tuple(f"backbone/{part}/{_csp_inner(rest)}".split("/"))

    # neck.<name>.rest — module names match the flax ones 1:1
    m = re.match(
        r"^neck\.(lateral_conv0|reduce_conv1|bu_conv1|bu_conv2|"
        r"C3_p4|C3_p3|C3_n3|C3_n4)\.(.*)$",
        name,
    )
    if m:
        return tuple(f"neck/{m.group(1)}/{_csp_inner(m.group(2))}".split("/"))

    # head towers: lists indexed by level
    m = re.match(r"^head\.stems\.(\d+)\.(.*)$", name)
    if m:
        return tuple(
            f"head/stem_{m.group(1)}/{m.group(2)}".replace(".", "/").split("/")
        )
    m = re.match(r"^head\.(cls|reg|kpt)_convs\.(\d+)\.(\d+)\.(.*)$", name)
    if m:
        kind, lvl, j, rest = m.groups()
        return tuple(
            f"head/{kind}_conv_{lvl}_{j}/{rest}".replace(".", "/").split("/")
        )
    m = re.match(r"^head\.(cls|reg|obj|kpt)_preds\.(\d+)$", name)
    if m:
        return ("head", f"{m.group(1)}_pred_{m.group(2)}")

    # fallthrough: dots to slashes
    return tuple(name.replace(".", "/").split("/"))


def map_darknet_torch_name(name: str) -> Tuple[str, ...]:
    """Translate reference Darknet-53 state-dict keys (``stem.conv``,
    ``dark{i}.0`` down conv, ``dark{i}.{j}.layer{1,2}`` residual convs) into
    the flax paths (``stem``, ``stage{i}_down``, ``stage{i}_res{j-1}/
    conv{1,2}``); a copy of ``yolov7_d2_tpu/utils/weight_port.py:102``."""
    m = re.match(r"^stem\.(conv|bn)$", name)
    if m:
        return ("stem", m.group(1))
    m = re.match(r"^dark(\d)\.0\.(conv|bn)$", name)
    if m:
        return (f"stage{m.group(1)}_down", m.group(2))
    m = re.match(r"^dark(\d)\.(\d+)\.layer(\d)\.(conv|bn)$", name)
    if m:
        lvl, j, k, leaf = m.groups()
        return (f"stage{lvl}_res{int(j) - 1}", f"conv{k}", leaf)
    return tuple(name.replace(".", "/").split("/"))


def map_cspdarknet_torch_name(name: str) -> Tuple[str, ...]:
    """Reference PP-YOLO CSP-DarkNet keys -> the flax paths; a copy of
    ``yolov7_d2_tpu/utils/weight_port.py:1017``."""
    if name == "conv1":
        return ("stem", "conv")
    if name == "bn1":
        return ("stem", "bn")
    m = re.match(
        r"^layer(\d)\.(base_layer|partial_transition1|partial_transition2|"
        r"fuse_transition)\.(\d)$", name)
    if m:
        lvl, part, j = m.groups()
        short = {"base_layer": "base", "partial_transition1": "pt1",
                 "partial_transition2": "pt2", "fuse_transition": "fuse"}
        return (f"stage{lvl}", short[part],
                {0: "conv", 1: "bn"}[int(j)])
    m = re.match(r"^layer(\d)\.stage_layers\.(\d+)\.downsample\.(\d)$", name)
    if m:
        lvl, blk, j = m.groups()
        return (f"stage{lvl}", f"block{blk}", "down",
                {0: "conv", 1: "bn"}[int(j)])
    m = re.match(r"^layer(\d)\.stage_layers\.(\d+)\.(conv|bn)(\d)$", name)
    if m:
        lvl, blk, kind, k = m.groups()
        return (f"stage{lvl}", f"block{blk}", f"conv{k}",
                "conv" if kind == "conv" else "bn")
    return tuple(name.replace(".", "/").split("/"))


def map_yolofpn_torch_name(name: str) -> Tuple[str, ...]:
    """Reference YOLOFPN keys -> the flax paths: ``out{0,1,2}.{j}`` 5-conv
    stacks -> ``block{5,4,3}/conv{j}``, ``out{1,2}_cbl`` laterals,
    ``spp.conv{1,2}``; a copy of ``yolov7_d2_tpu/utils/weight_port.py:1046``.
    """
    m = re.match(r"^out(\d)\.(\d)\.(conv|bn)$", name)
    if m:
        lvl, j, leaf = m.groups()
        return ({"0": "block5", "1": "block4", "2": "block3"}[lvl],
                f"conv{j}", leaf)
    m = re.match(r"^out(\d)_cbl\.(conv|bn)$", name)
    if m:
        return (f"lateral{m.group(1)}", m.group(2))
    m = re.match(r"^spp\.conv(\d)\.(conv|bn)$", name)
    if m:
        return ("spp", f"conv{m.group(1)}", m.group(2))
    return tuple(name.replace(".", "/").split("/"))


def map_anchor_yolo_torch_name(name: str,
                               backbone_type: str = "darknet53"
                               ) -> Tuple[str, ...]:
    """Translate a key of the port's ``AnchorYOLO`` (``models/meta_arch/
    yolov7.py``) into the flax path of the JAX ``AnchorYOLO``, by prefix:
    ``backbone.`` through the map of ``backbone_type`` (``darknet53``,
    ``cspdarknet53``, ``cspdarknetx``, ``resnet``, ``resnet_vd``,
    ``res2net`` (v1b / v1d), ``res2next``, ``swin``,
    ``pvt_v2``, ``yolov5`` or ``efficientrep``, whose names overlap, so
    the caller says which), ``neck.`` through the BiFPN map, the YOLOFPN map or the YOLOX
    one (YOLOPAFPN; PP-YOLO's PAN has the flax names),
    ``head.towers.{l}`` -> ``head/tower_{l}`` and ``head.preds.{l}`` ->
    ``head/pred_{l}``."""
    prefix, _, rest = name.partition(".")
    if prefix == "backbone":
        if backbone_type == "yolov5":
            return ("backbone",) + map_yolov5_torch_name(rest)
        if backbone_type == "efficientrep":
            return ("backbone",) + map_efficientrep_torch_name(rest)
        if backbone_type in BACKBONE_MAPS:
            return ("backbone",) + BACKBONE_MAPS[backbone_type](rest)
        if backbone_type in ("resnet", "resnet_vd"):
            return map_resnet_torch_name(name, backbone_type == "resnet_vd")
        if backbone_type == "res2net":
            return ("backbone",) + map_res2net_torch_name(rest)
        if backbone_type == "res2next":
            return ("backbone",) + map_res2next_torch_name(rest)
        if backbone_type == "cspdarknetx":
            return map_yolox_torch_name(name)
        mapper = (map_cspdarknet_torch_name
                  if backbone_type == "cspdarknet53"
                  else map_darknet_torch_name)
        return ("backbone",) + mapper(rest)
    if prefix == "neck":
        if re.match(r"^(resample|cell)\.", rest):
            return ("neck",) + map_bifpn_torch_name(rest)
        if re.match(r"^(out\d|spp)", rest):
            return ("neck",) + map_yolofpn_torch_name(rest)
        return map_yolox_torch_name(name)
    m = re.match(r"^head\.towers\.(\d+)\.(.*)$", name)
    if m:
        return ("head", f"tower_{m.group(1)}", *m.group(2).split("."))
    m = re.match(r"^head\.preds\.(\d+)$", name)
    if m:
        return ("head", f"pred_{m.group(1)}")
    return tuple(name.replace(".", "/").split("/"))


def map_d2_resnet_name(name: str) -> Tuple[str, ...]:
    """detectron2 ResNet keys (``backbone.stem.conv1[.norm]``,
    ``backbone.res{s}.{i}.{conv1,conv2,conv3,shortcut}[.norm]``) -> the
    flax paths (``backbone/stem/{conv,bn}``, ``backbone/res{s}_{i}/{part}/
    {conv,bn}``); a copy of ``yolov7_d2_tpu/utils/weight_port.py:151``."""
    m = re.match(r"^backbone\.stem\.conv1\.norm$", name)
    if m:
        return ("backbone", "stem", "bn")
    m = re.match(r"^backbone\.stem\.conv1$", name)
    if m:
        return ("backbone", "stem", "conv")
    m = re.match(r"^backbone\.res(\d)\.(\d+)\.(conv\d|shortcut)(\.norm)?$",
                 name)
    if m:
        stage, idx, part, norm = m.groups()
        return (
            "backbone", f"res{stage}_{idx}", part, "bn" if norm else "conv",
        )
    return tuple(name.replace(".", "/").split("/"))


def map_resnet_torch_name(name: str, vd: bool = False) -> Tuple[str, ...]:
    """A key of the port's ResNet (``models/backbones/resnet.py``, under
    ``backbone.``) -> the flax path: :func:`map_d2_resnet_name`, except the
    vd stem, whose ``stem.conv{k}`` are the flax ``stem{k}``, and a DCN
    block's ``conv2_dcn`` (the fuse, ``.offset_conv``) and ``conv2_bn``,
    which keep the flax names (``conv2_dcn/weight``,
    ``conv2_dcn/offset_conv``, ``conv2_bn``)."""
    m = re.match(r"^backbone\.stem\.conv(\d)(\.norm)?$", name)
    if vd and m:
        return ("backbone", f"stem{m.group(1)}",
                "bn" if m.group(2) else "conv")
    m = re.match(r"^backbone\.res(\d)\.(\d+)\.(conv2_dcn|conv2_bn)"
                 r"(\.offset_conv)?$", name)
    if m:
        stage, idx, part, offset = m.groups()
        leaf = (("offset_conv",) if offset else ("weight",)) \
            if part == "conv2_dcn" else ()
        return ("backbone", f"res{stage}_{idx}", part) + leaf
    return map_d2_resnet_name(name)


def map_res2net_torch_name(name: str) -> Tuple[str, ...]:
    """Reference Res2Net-v1b keys (the port's ``models/backbones/
    res2net.py``) -> the JAX Res2Net's flax paths: the deep stem
    ``conv1.{0,1,3,4,6}`` and the outer ``bn1`` -> ``stem{1,2,3}``; blocks
    ``layerL.i.{conv1,bn1,convs.j,bns.j,conv3,bn3,downsample.{1,2}}`` ->
    ``res{L+1}_{i}/{conv1,conv2_j,conv3,shortcut}/{conv,bn}``; a copy of
    ``yolov7_d2_tpu/utils/weight_port.py:488``."""
    m = re.match(r"^conv1\.(\d)$", name)
    if m:
        return {0: ("stem1", "conv"), 1: ("stem1", "bn"),
                3: ("stem2", "conv"), 4: ("stem2", "bn"),
                6: ("stem3", "conv")}[int(m.group(1))]
    if name == "bn1":
        return ("stem3", "bn")
    m = re.match(r"^layer(\d)\.(\d+)\.(conv|bn)(\d)$", name)
    if m:
        lvl, i, kind, k = m.groups()
        return (f"res{int(lvl) + 1}_{i}", f"conv{k}",
                "conv" if kind == "conv" else "bn")
    m = re.match(r"^layer(\d)\.(\d+)\.(convs|bns)\.(\d+)$", name)
    if m:
        lvl, i, kind, j = m.groups()
        return (f"res{int(lvl) + 1}_{i}", f"conv2_{j}",
                "conv" if kind == "convs" else "bn")
    m = re.match(r"^layer(\d)\.(\d+)\.downsample\.(\d)$", name)
    if m:
        lvl, i, j = m.groups()
        leaf = {1: "conv", 2: "bn"}[int(j)]
        return (f"res{int(lvl) + 1}_{i}", "shortcut", leaf)
    return tuple(name.replace(".", "/").split("/"))


def map_res2next_torch_name(name: str) -> Tuple[str, ...]:
    """Res2NeXt-50 keys: the plain 7x7 stem (``conv1`` / ``bn1`` ->
    ``stem``) and the 1x1 shortcut without a pool (``downsample.{0,1}``);
    the blocks as :func:`map_res2net_torch_name`; a copy of
    ``yolov7_d2_tpu/utils/weight_port.py:517``."""
    if name == "conv1":
        return ("stem", "conv")
    if name == "bn1":
        return ("stem", "bn")
    m = re.match(r"^layer(\d)\.(\d+)\.downsample\.(\d)$", name)
    if m:
        lvl, i, j = m.groups()
        leaf = {0: "conv", 1: "bn"}[int(j)]
        return (f"res{int(lvl) + 1}_{i}", "shortcut", leaf)
    return map_res2net_torch_name(name)


def map_sparseinst_encoder_torch_name(name: str) -> Tuple[str, ...]:
    """Reference ``InstanceContextEncoder`` keys -> the JAX encoder's flax
    paths (``fpn_laterals`` / ``fpn_outputs`` deepest first: c5, c4, c3);
    a copy of ``yolov7_d2_tpu/utils/weight_port.py:533``."""
    m = re.match(r"^fpn_laterals\.(\d)$", name)
    if m:
        return (f"lateral{5 - int(m.group(1))}",)
    m = re.match(r"^fpn_outputs\.(\d)$", name)
    if m:
        return (f"out{5 - int(m.group(1))}",)
    m = re.match(r"^ppm\.stages\.(\d)\.1$", name)
    if m:
        return ("ppm", f"pool_conv_{m.group(1)}")
    if name == "ppm.bottleneck":
        return ("ppm", "bottleneck")
    if name == "fusion":
        return ("fusion",)
    return tuple(name.replace(".", "/").split("/"))


def map_sparseinst_decoder_torch_name(name: str) -> Tuple[str, ...]:
    """Reference Base/GroupIAMDecoder keys -> the JAX ``IAMDecoder``'s flax
    paths (``inst_convs`` / ``mask_convs`` are Sequential(conv, relu, ...):
    convolutions at even indices); a copy of
    ``yolov7_d2_tpu/utils/weight_port.py:553``."""
    m = re.match(r"^inst_branch\.inst_convs\.(\d+)$", name)
    if m:
        return (f"inst_conv_{int(m.group(1)) // 2}",)
    m = re.match(r"^mask_branch\.mask_convs\.(\d+)$", name)
    if m:
        return (f"mask_conv_{int(m.group(1)) // 2}",)
    simple = {
        "inst_branch.iam_conv": ("iam_conv",),
        "inst_branch.fc": ("fc",),
        "inst_branch.cls_score": ("cls_score",),
        "inst_branch.mask_kernel": ("mask_kernel",),
        "inst_branch.objectness": ("objectness",),
        "mask_branch.projection": ("mask_proj",),
    }
    if name in simple:
        return simple[name]
    return tuple(name.replace(".", "/").split("/"))


def map_sparseinst_torch_name(name: str, vd: bool = False
                              ) -> Tuple[str, ...]:
    """A key of the port's ``SparseInst`` -> the flax path of the JAX
    model, by prefix: ``backbone.`` through :func:`map_resnet_torch_name`,
    ``encoder.`` and ``decoder.`` through the two SparseInst maps."""
    prefix, _, rest = name.partition(".")
    if prefix == "encoder":
        return ("encoder",) + map_sparseinst_encoder_torch_name(rest)
    if prefix == "decoder":
        return ("decoder",) + map_sparseinst_decoder_torch_name(rest)
    return map_resnet_torch_name(name, vd)


def _attention_out(parts: Tuple[str, ...]) -> Tuple[str, ...]:
    """``.../<attn>/out_proj`` of a flax ``MultiHeadDotProductAttention``
    -> ``.../<attn>/out``."""
    return parts[:-1] + ("out",) if parts[-1] == "out_proj" else parts


def map_detr_torch_name(name: str) -> Tuple[str, ...]:
    """A key of the port's DETR (the reference's names) -> the flax path of
    the JAX ``DETR``: ``backbone.`` through :func:`map_d2_resnet_name`, the
    rest through a copy of the JAX ``map_detr_torch_name`` (``transformer.
    encoder.layers.N`` -> ``transformer/enc_N``, ``decoder.norm`` ->
    ``dec_norm``, ``bbox_embed.layers.N`` -> ``bbox_embed/layer_N``), with
    the attention renames that the JAX ``port_detr_state_dict`` makes:
    ``multihead_attn`` -> ``cross_attn``, ``out_proj`` -> ``out``."""
    if name.startswith("backbone."):
        return map_d2_resnet_name(name)
    n = re.sub(r"^detr\.", "", name)
    n = re.sub(r"^transformer\.encoder\.layers\.(\d+)\.",
               r"transformer/enc_\1/", n)
    n = re.sub(r"^transformer\.decoder\.layers\.(\d+)\.",
               r"transformer/dec_\1/", n)
    n = n.replace("transformer.decoder.norm", "transformer/dec_norm")
    n = n.replace("transformer.encoder.norm", "transformer/enc_norm")
    n = re.sub(r"^bbox_embed\.layers\.(\d+)$", r"bbox_embed/layer_\1", n)
    parts = tuple(n.replace(".", "/").split("/"))
    parts = tuple("cross_attn" if p == "multihead_attn" else p
                  for p in parts)
    if len(parts) >= 2 and parts[-2] in ("self_attn", "cross_attn"):
        parts = _attention_out(parts)
    return parts


def map_anchor_detr_torch_name(name: str,
                               attention_type: str = "RCDA"
                               ) -> Tuple[str, ...]:
    """A key of the port's ``AnchorDETR`` -> the flax path of the JAX
    model: ``backbone.`` through :func:`map_d2_resnet_name`,
    ``transformer.encoder.layers.N`` -> ``enc_N``,
    ``transformer.decoder.layers.N`` -> ``dec_N``, ``bbox_embed.layers.N``
    -> ``bbox_embed/layer_N``. The decoders' ``self_attn`` and, with
    ``attention_type`` "nn.MultiheadAttention", the encoders' are flax
    attention (``out_proj`` -> ``out``); the RCDA modules keep their
    ``out_proj``."""
    if name.startswith("backbone."):
        return map_d2_resnet_name(name)
    m = re.match(r"^transformer\.(encoder|decoder)\.layers\.(\d+)\.(.*)$",
                 name)
    if m:
        kind, i, rest = m.groups()
        parts = (f"{kind[:3]}_{i}",) + tuple(rest.split("."))
        dense = (kind == "decoder"
                 or attention_type == "nn.MultiheadAttention")
        if dense and parts[1] == "self_attn":
            parts = _attention_out(parts)
        return parts
    m = re.match(r"^bbox_embed\.layers\.(\d+)$", name)
    if m:
        return ("bbox_embed", f"layer_{m.group(1)}")
    return tuple(name.split(".")) if name else ()


def map_detr_variant_torch_name(name: str, backbone_type: str = "resnet"
                                ) -> Tuple[str, ...]:
    """A key of the port's ``DABDETR`` or ``DetrD2go`` (SMCA-DETR among
    them) -> the flax path of the JAX model: ``backbone.`` through
    :func:`map_d2_resnet_name` (``backbone_type`` "resnet"), the YOLOX map
    ("cspdarknetx") or the zoo's map in :data:`BACKBONE_MAPS`;
    ``transformer.encoder.layers.N`` -> ``enc_N``,
    ``transformer.decoder.layers.N`` -> ``dec_N`` (flax attention:
    ``multihead_attn`` -> ``cross_attn``, ``out_proj`` -> ``out``; SMCA's
    ``ca_*`` are plain), ``bbox_embed`` / ``cs_head.layers.N`` ->
    ``.../layer_N``, ``dec_norms.N`` -> ``dec_norm_N``."""
    prefix, _, rest = name.partition(".")
    if prefix == "backbone":
        if backbone_type == "resnet":
            return map_d2_resnet_name(name)
        if backbone_type == "cspdarknetx":
            return map_yolox_torch_name(name)
        return ("backbone",) + BACKBONE_MAPS[backbone_type](rest)
    m = re.match(r"^transformer\.(encoder|decoder)\.layers\.(\d+)\.(.*)$",
                 name)
    if m:
        kind, i, rest = m.groups()
        parts = (f"{kind[:3]}_{i}",) + tuple(
            "cross_attn" if p == "multihead_attn" else p
            for p in rest.split("."))
        if parts[1] in ("self_attn", "cross_attn"):
            parts = _attention_out(parts)
        return parts
    m = re.match(r"^(bbox_embed|cs_head)\.layers\.(\d+)$", name)
    if m:
        return (m.group(1), f"layer_{m.group(2)}")
    m = re.match(r"^dec_norms\.(\d+)$", name)
    if m:
        return (f"dec_norm_{m.group(1)}",)
    return tuple(name.split(".")) if name else ()


def map_swin_torch_name(name: str) -> Tuple[str, ...]:
    """Reference Swin keys (``patch_embed.proj``, ``layers.{s}.blocks.{i}.
    ...``, ``layers.{s}.downsample.{norm, reduction}``, ``norm{s}``) ->
    the flax paths of the JAX ``SwinTransformer`` (``patch_embed``,
    ``stage{s}_block{i}/...``, ``merge_{s+1}``, ``out_norm_{s}``); a copy
    of ``yolov7_d2_tpu/utils/weight_port.py:731``."""
    if name == "patch_embed.proj":
        return ("patch_embed",)
    if name == "patch_embed.norm":
        return ("patch_norm",)
    m = re.match(r"^layers\.(\d)\.blocks\.(\d+)\.(.*)$", name)
    if m:
        s, i, rest = m.groups()
        rest = {
            "norm1": "norm1", "norm2": "norm2",
            "attn.qkv": "attn/qkv", "attn.proj": "attn/proj",
            "mlp.fc1": "mlp1", "mlp.fc2": "mlp2",
        }.get(rest, rest.replace(".", "/"))
        return tuple(f"stage{s}_block{i}/{rest}".split("/"))
    m = re.match(r"^layers\.(\d)\.downsample\.(norm|reduction)$", name)
    if m:
        return (f"merge_{int(m.group(1)) + 1}", m.group(2))
    m = re.match(r"^norm(\d)$", name)
    if m:
        return (f"out_norm_{m.group(1)}",)
    return tuple(name.replace(".", "/").split("/"))


def map_pvt_v2_torch_name(name: str) -> Tuple[str, ...]:
    """Reference PVTv2 keys (``patch_embed{1..4}``, ``block{1..4}.{i}``,
    ``norm{1..4}``; 1-based stages) -> the flax paths of the JAX ``PVTv2``
    (0-based ``patch_embed_{s}``, ``embed_norm_{s}``, ``stage{s}_block{i}``,
    ``out_norm_{s}``); a copy of ``yolov7_d2_tpu/utils/weight_port.py:963``.
    """
    m = re.match(r"^patch_embed(\d)\.proj$", name)
    if m:
        return (f"patch_embed_{int(m.group(1)) - 1}",)
    m = re.match(r"^patch_embed(\d)\.norm$", name)
    if m:
        return (f"embed_norm_{int(m.group(1)) - 1}",)
    m = re.match(r"^norm(\d)$", name)
    if m:
        return (f"out_norm_{int(m.group(1)) - 1}",)
    m = re.match(r"^block(\d)\.(\d+)\.(.*)$", name)
    if m:
        stage, i, rest = int(m.group(1)) - 1, m.group(2), m.group(3)
        base = (f"stage{stage}_block{i}",)
        table = {
            "norm1": ("norm1",), "norm2": ("norm2",),
            "attn.q": ("attn", "q"), "attn.kv": ("attn", "kv"),
            "attn.proj": ("attn", "proj"), "attn.sr": ("attn", "sr"),
            "attn.norm": ("attn", "sr_norm"),
            "mlp.fc1": ("ffn", "fc1"), "mlp.fc2": ("ffn", "fc2"),
            "mlp.dwconv.dwconv": ("ffn", "dwconv"),
        }
        if rest in table:
            return base + table[rest]
        return base + tuple(rest.split("."))
    return tuple(name.replace(".", "/").split("/"))


def _rep_leaf(rest: str) -> str:
    """A RepVGG block's inner name -> its flax module name
    (``rbr_dense.conv`` -> ``rbr_dense_conv``, ``rbr_identity`` ->
    ``rbr_identity_bn``)."""
    if rest == "rbr_identity":
        return "rbr_identity_bn"
    return rest.replace(".", "_")


def map_efficientrep_torch_name(name: str) -> Tuple[str, ...]:
    """Reference EfficientRep keys (``stem``, ``ERBlock_{i}.0`` the down
    block, ``ERBlock_{i}.1`` the RepBlock's ``conv1`` / ``block.{j}``,
    ``ERBlock_5.2.cv{1,2}`` the SimSPPF) -> the flax paths (``stem``,
    ``down{i}``, ``stage{i}/rep_{j}``, ``sppf/conv{1,2}``); a copy of
    ``yolov7_d2_tpu/utils/weight_port.py:120``."""
    m = re.match(r"^stem\.(.*)$", name)
    if m:
        return ("stem", _rep_leaf(m.group(1)))
    m = re.match(r"^ERBlock_(\d)\.0\.(.*)$", name)
    if m:
        return (f"down{m.group(1)}", _rep_leaf(m.group(2)))
    m = re.match(r"^ERBlock_(\d)\.1\.conv1\.(.*)$", name)
    if m:
        return (f"stage{m.group(1)}", "rep_0", _rep_leaf(m.group(2)))
    m = re.match(r"^ERBlock_(\d)\.1\.block\.(\d+)\.(.*)$", name)
    if m:
        lvl, j, rest = m.groups()
        return (f"stage{lvl}", f"rep_{int(j) + 1}", _rep_leaf(rest))
    m = re.match(r"^ERBlock_5\.2\.cv(\d)\.(conv|bn)$", name)
    if m:
        return ("sppf", f"conv{m.group(1)}", m.group(2))
    return tuple(name.replace(".", "/").split("/"))


def map_reppan_torch_name(name: str) -> Tuple[str, ...]:
    """Reference RepPANNeck keys -> the flax paths (``reduce_layer{0,1}``
    -> ``reduce{0,1}``, ``downsample{2,1}`` -> ``down{1,0}``,
    ``upsample{i}.upsample_transpose`` -> ``upsample{i}``, ``Rep_{p4,...}``
    -> ``rep_{p4,...}/rep_{j}``); a copy of
    ``yolov7_d2_tpu/utils/weight_port.py:576``."""
    simple = {
        "reduce_layer0": "reduce0", "reduce_layer1": "reduce1",
        "downsample2": "down1", "downsample1": "down0",
    }
    m = re.match(r"^(reduce_layer0|reduce_layer1|downsample2|downsample1)"
                 r"\.(conv|bn)$", name)
    if m:
        return (simple[m.group(1)], m.group(2))
    m = re.match(r"^upsample(\d)\.upsample_transpose$", name)
    if m:
        return (f"upsample{m.group(1)}",)
    m = re.match(r"^Rep_([pn]\d)\.conv1\.(.*)$", name)
    if m:
        return (f"rep_{m.group(1)}", "rep_0", _rep_leaf(m.group(2)))
    m = re.match(r"^Rep_([pn]\d)\.block\.(\d+)\.(.*)$", name)
    if m:
        return (f"rep_{m.group(1)}", f"rep_{int(m.group(2)) + 1}",
                _rep_leaf(m.group(3)))
    return tuple(name.replace(".", "/").split("/"))


def map_effidehead_torch_name(name: str) -> Tuple[str, ...]:
    """Reference EffiDeHead keys (``stems.{l}``, ``{cls,reg}_convs.{l}``,
    ``{cls,reg,obj}_preds.{l}``) -> the flax paths (``stem_{l}``,
    ``{cls,reg}_conv_{l}``, ``{cls,reg,obj}_pred_{l}``); a copy of
    ``yolov7_d2_tpu/utils/weight_port.py:605``."""
    m = re.match(r"^stems\.(\d)\.(conv|bn)$", name)
    if m:
        return (f"stem_{m.group(1)}", m.group(2))
    m = re.match(r"^(cls|reg)_convs\.(\d)\.(conv|bn)$", name)
    if m:
        return (f"{m.group(1)}_conv_{m.group(2)}", m.group(3))
    m = re.match(r"^(cls|reg|obj)_preds\.(\d)$", name)
    if m:
        return (f"{m.group(1)}_pred_{m.group(2)}",)
    return tuple(name.replace(".", "/").split("/"))


def map_yolov6_torch_name(name: str) -> Tuple[str, ...]:
    """A key of the port's ``YOLOV6`` -> the flax path of the JAX model, by
    prefix: ``backbone.`` through :func:`map_efficientrep_torch_name`,
    ``neck.`` through :func:`map_reppan_torch_name`, ``head.`` through
    :func:`map_effidehead_torch_name`."""
    prefix, _, rest = name.partition(".")
    sub = {"backbone": map_efficientrep_torch_name,
           "neck": map_reppan_torch_name,
           "head": map_effidehead_torch_name}.get(prefix)
    if sub is None:
        return tuple(name.split("."))
    return (prefix,) + sub(rest)


def map_yolov5_torch_name(name: str) -> Tuple[str, ...]:
    """A key of the port's YOLOv5 backbone (the flax module names, YOLOX's
    CSP inner names) -> the flax path: ``stage2_2.m.0.conv1.conv`` ->
    ``stage2_2/m_0/conv1/conv``."""
    part, _, rest = name.partition(".")
    return tuple(f"{part}/{_csp_inner(rest)}".split("/")) if rest else (
        part,)


def map_bifpn_torch_name(name: str) -> Tuple[str, ...]:
    """Reference BiFPN keys -> the flax module names: ``resample.{L}.conv.
    {conv,bn}`` (the extra levels), ``cell.{r}.fnode.{i}.combine.resample.
    {off}.conv.{conv,bn}`` (an edge's resampling), ``cell.{r}.fnode.{i}.
    after_combine.conv.{conv,bn,conv_dw,conv_pw}`` (a node's refinement);
    a copy of ``yolov7_d2_tpu/utils/weight_port.py:1128``. The port adds
    ``cell.{r}.fnode.{i}.combine`` -> ``cell{r}_fnode{i}_edge``, the flax
    parameter its ``edge_weights`` is (the JAX ``port_bifpn_state_dict``
    moves it by hand)."""
    m = re.match(r"^resample\.(\d+)\.conv\.(conv|bn)$", name)
    if m:
        return (f"resample_{m.group(1)}_{m.group(2)}",)
    m = re.match(r"^cell\.(\d+)\.fnode\.(\d+)\.combine\.resample\.(\d+)"
                 r"\.conv\.(conv|bn)$", name)
    if m:
        r, i, off, leaf = m.groups()
        return (f"cell{r}_fnode{i}_res{off}_{leaf}",)
    m = re.match(r"^cell\.(\d+)\.fnode\.(\d+)\.after_combine\.conv"
                 r"\.(conv_dw|conv_pw|conv|bn)$", name)
    if m:
        r, i, leaf = m.groups()
        suffix = {"conv": "conv", "bn": "bn", "conv_dw": "dw",
                  "conv_pw": "pw"}[leaf]
        return (f"cell{r}_fnode{i}_conv_{suffix}",)
    m = re.match(r"^cell\.(\d+)\.fnode\.(\d+)\.combine$", name)
    if m:
        return (f"cell{m.group(1)}_fnode{m.group(2)}_edge",)
    return tuple(name.replace(".", "/").split("/"))


def map_yolof_encoder_torch_name(name: str) -> Tuple[str, ...]:
    """Reference DilatedEncoder keys -> the flax paths (``lateral_conv`` /
    ``lateral_norm`` -> ``lateral_conv`` / ``lateral_bn``,
    ``dilated_encoder_blocks.{i}.conv{1,2,3}.{0 conv, 1 norm}`` ->
    ``b{i}_{reduce,dilated,project}_{conv,bn}``); a copy of
    ``yolov7_d2_tpu/utils/weight_port.py:1064``."""
    table = {
        "lateral_conv": ("lateral_conv",), "lateral_norm": ("lateral_bn",),
        "fpn_conv": ("fpn_conv",), "fpn_norm": ("fpn_bn",),
    }
    if name in table:
        return table[name]
    m = re.match(r"^dilated_encoder_blocks\.(\d+)\.conv(\d)\.(\d)$", name)
    if m:
        i, k, j = m.groups()
        part = {"1": "reduce", "2": "dilated", "3": "project"}[k]
        leaf = {"0": "conv", "1": "bn"}[j]
        return (f"b{i}_{part}_{leaf}",)
    return tuple(name.replace(".", "/").split("/"))


def map_yolof_decoder_torch_name(name: str) -> Tuple[str, ...]:
    """Reference Decoder keys -> the flax paths (``{cls,bbox}_subnet.{n}``
    (conv, norm, act) triplets -> ``{cls,reg}_{n // 3}_{conv,bn}``; the
    predictions keep their names); a copy of
    ``yolov7_d2_tpu/utils/weight_port.py:1083``."""
    m = re.match(r"^(cls|bbox)_subnet\.(\d+)$", name)
    if m:
        kind, idx = m.group(1), int(m.group(2))
        i, j = idx // 3, idx % 3
        pre = "cls" if kind == "cls" else "reg"
        leaf = {0: "conv", 1: "bn"}[j]
        return (f"{pre}_{i}_{leaf}",)
    if name in ("cls_score", "bbox_pred", "object_pred"):
        return (name,)
    return tuple(name.replace(".", "/").split("/"))


def map_yolof_torch_name(name: str) -> Tuple[str, ...]:
    """A key of the port's ``YOLOF`` -> the flax path of the JAX model:
    ``backbone.`` through :func:`map_resnet_torch_name`, ``encoder.`` and
    ``decoder.`` through the two YOLOF maps."""
    prefix, _, rest = name.partition(".")
    if prefix == "encoder":
        return ("encoder",) + map_yolof_encoder_torch_name(rest)
    if prefix == "decoder":
        return ("decoder",) + map_yolof_decoder_torch_name(rest)
    return map_resnet_torch_name(name)


def map_convnext_torch_name(name: str) -> Tuple[str, ...]:
    """Reference ConvNeXt keys (the port's ``models/backbones/
    convnext.py``) -> the flax paths: ``downsample_layers.0.{0,1}`` ->
    ``stem_conv`` / ``stem_norm``, ``downsample_layers.{s}.{0,1}`` ->
    ``down_norm_{s}`` / ``down_conv_{s}``, ``stages.{s}.{i}[.part]`` ->
    ``stage{s}_block{i}[/part]`` (the block owns ``gamma``), ``norm{s}`` ->
    ``out_norm_{s}``; a copy of ``yolov7_d2_tpu/utils/weight_port.py:
    659``."""
    m = re.match(r"^downsample_layers\.0\.(\d)$", name)
    if m:
        return ("stem_conv",) if m.group(1) == "0" else ("stem_norm",)
    m = re.match(r"^downsample_layers\.(\d)\.(\d)$", name)
    if m:
        s, j = m.groups()
        return (f"down_norm_{s}",) if j == "0" else (f"down_conv_{s}",)
    m = re.match(r"^stages\.(\d)\.(\d+)\.(dwconv|norm|pwconv1|pwconv2)$",
                 name)
    if m:
        s, i, leafmod = m.groups()
        return (f"stage{s}_block{i}", leafmod)
    m = re.match(r"^stages\.(\d)\.(\d+)$", name)  # layer-scale gamma owner
    if m:
        return (f"stage{m.group(1)}_block{m.group(2)}",)
    m = re.match(r"^norm(\d)$", name)
    if m:
        return (f"out_norm_{m.group(1)}",)
    return tuple(name.replace(".", "/").split("/"))


def map_efficientnet_torch_name(name: str) -> Tuple[str, ...]:
    """Reference EfficientNet keys (``_conv_stem`` / ``_bn0``,
    ``_blocks.{i}._expand_conv`` / ``_bn0`` / ``_depthwise_conv`` /
    ``_bn1`` / ``_se_reduce`` / ``_se_expand`` / ``_project_conv`` /
    ``_bn2``) -> the flax paths (``stem_conv``, ``block{i}/expand_conv``
    ...); a copy of ``yolov7_d2_tpu/utils/weight_port.py:994``."""
    if name == "_conv_stem":
        return ("stem_conv",)
    if name == "_bn0":
        return ("stem_bn",)
    m = re.match(r"^_blocks\.(\d+)\.(.*)$", name)
    if m:
        i, rest = m.groups()
        table = {
            "_expand_conv": ("expand_conv",), "_bn0": ("expand_bn",),
            "_depthwise_conv": ("dw_conv",), "_bn1": ("dw_bn",),
            "_se_reduce": ("se_reduce",), "_se_expand": ("se_expand",),
            "_project_conv": ("project_conv",), "_bn2": ("project_bn",),
        }
        if rest in table:
            return (f"block{i}",) + table[rest]
        return (f"block{i}",) + tuple(rest.split("."))
    return tuple(name.replace(".", "/").split("/"))


def _map_dla_block_inner(rest: str, block: str = "basic"
                         ) -> Tuple[str, ...]:
    """Names inside a DLA tree leaf: the basic block's flat
    ``conv1/bn1/conv2/bn2``; the bottleneck's ``conv1`` and ``conv3`` in
    ConvBN around a raw middle conv; a copy of
    ``yolov7_d2_tpu/utils/weight_port.py:813``."""
    if block == "basic":
        return (rest,)
    table = {
        "conv1": ("conv1", "conv"), "bn1": ("conv1", "bn"),
        "conv2": ("conv2",), "bn2": ("bn2",),
        "conv3": ("conv3", "conv"), "bn3": ("conv3", "bn"),
    }
    if rest in table:
        return table[rest]
    return tuple(rest.split("."))


def map_dla_torch_name(name: str, block: str = "basic") -> Tuple[str, ...]:
    """Reference DLA / DLASeg module names (the port's ``models/backbones/
    dla.py``) -> the JAX flax paths: ``base_layer.{0,1}`` -> ``base/{conv,
    bn}``, ``level{0,1}.{3c,3c+1}`` -> ``level{0,1}_{c}/{conv,bn}``, the
    trees structurally (``project.{0,1}`` -> ``project/{conv,bn}``,
    ``root.{conv,bn}`` -> ``root/conv/{conv,bn}``), the decoders'
    ``proj_{j}`` / ``node_{j}`` ``offset`` -> ``dcn/offset_conv``,
    ``conv`` -> ``dcn/weight``, ``actf.0`` -> ``bn``, and ``up_{j}``; a
    ``base.`` prefix (DLASeg) is kept. A copy of
    ``yolov7_d2_tpu/utils/weight_port.py:829``."""
    parts = name.split(".")
    out = []
    i = 0
    if parts[0] == "base":
        out.append("base")
        i = 1
    if i < len(parts) and parts[i] == "base_layer":
        idx = int(parts[i + 1])
        return tuple(out + ["base", {0: "conv", 1: "bn"}[idx]])
    if i < len(parts) and re.match(r"^level[01]$", parts[i]):
        lvl = parts[i]
        idx = int(parts[i + 1])
        return tuple(out + [f"{lvl}_{idx // 3}",
                            {0: "conv", 1: "bn"}[idx % 3]])
    if i < len(parts) and re.match(r"^level[2-5]$", parts[i]):
        out.append(parts[i])
        i += 1
        while i < len(parts):
            p = parts[i]
            if p in ("tree1", "tree2"):
                nxt = parts[i + 1] if i + 1 < len(parts) else ""
                if nxt in ("conv1", "bn1", "conv2", "bn2", "conv3", "bn3"):
                    out.append(p)
                    out.extend(_map_dla_block_inner(nxt, block))
                    return tuple(out)
                out.append(p)
                i += 1
                continue
            if p == "project":
                j = int(parts[i + 1])
                return tuple(out + ["project", {0: "conv", 1: "bn"}[j]])
            if p == "root":
                leaf = parts[i + 1]
                return tuple(out + ["root", "conv",
                                    {"conv": "conv", "bn": "bn"}[leaf]])
            out.append(p)
            i += 1
        return tuple(out)
    if parts[i] in ("dla_up", "ida_up"):
        out.append(parts[i])
        i += 1
        if parts[i].startswith("ida_"):
            out.append(parts[i])
            i += 1
        p = parts[i]
        m = re.match(r"^(proj|node)_(\d+)$", p)
        if m:
            sub = parts[i + 1]
            if sub == "offset":
                return tuple(out + [p, "dcn", "offset_conv"])
            if sub == "conv":
                return tuple(out + [p, "dcn", "weight"])
            if sub == "actf":
                return tuple(out + [p, "bn"])
        m = re.match(r"^up_(\d+)$", p)
        if m:
            return tuple(out + [p])
    return tuple(name.replace(".", "/").split("/"))


def map_solov2_ins_torch_name(name: str, use_dcn: bool = False,
                              num_convs: int = 4) -> Tuple[str, ...]:
    """Reference ``SOLOv2InsHead`` keys -> the JAX head's flax names:
    ``{cate,kernel}_tower.{3i}`` (conv) / ``.{3i+1}`` (GN) ->
    ``{kind}_conv_{i}`` / ``{kind}_gn_{i}``; with ``use_dcn`` the last
    tower conv is the deformable ``{kind}_dcn_{i}`` (its fuse ``weight``,
    its ``offset_conv``). A copy of ``yolov7_d2_tpu/utils/weight_port.py:
    1099`` with the DCN towers added."""
    m = re.match(r"^(cate|kernel)_tower\.(\d+)(\.offset_conv)?$", name)
    if m:
        kind, idx, offset = m.group(1), int(m.group(2)), m.group(3)
        i, j = idx // 3, idx % 3
        if j == 0 and use_dcn and i == num_convs - 1:
            return (f"{kind}_dcn_{i}",
                    "offset_conv" if offset else "weight")
        return (f"{kind}_{'conv' if j == 0 else 'gn'}_{i}",)
    if name in ("cate_pred", "kernel_pred"):
        return (name,)
    return tuple(name.replace(".", "/").split("/"))


def map_solov2_mask_torch_name(name: str) -> Tuple[str, ...]:
    """Reference ``SOLOv2MaskHead`` keys -> the JAX head's flax names:
    ``convs_all_levels.{i}.conv{j}.{0,1}`` -> ``l{i}_c{j}_{conv,gn}``,
    ``conv_pred.{0,1}`` -> ``pred_{conv,gn}``; a copy of
    ``yolov7_d2_tpu/utils/weight_port.py:1114``."""
    m = re.match(r"^convs_all_levels\.(\d+)\.conv(\d+)\.(\d)$", name)
    if m:
        i, j, k = m.groups()
        return (f"l{i}_c{j}_{'conv' if k == '0' else 'gn'}",)
    m = re.match(r"^conv_pred\.(\d)$", name)
    if m:
        return (f"pred_{'conv' if m.group(1) == '0' else 'gn'}",)
    return tuple(name.replace(".", "/").split("/"))


def map_solov2_torch_name(name: str, use_dcn: bool = False
                          ) -> Tuple[str, ...]:
    """A key of the port's ``SOLOv2`` -> the flax path of the JAX model, by
    prefix: ``backbone.`` through :func:`map_d2_resnet_name`, ``fpn.`` by
    its flax names, ``ins_head.`` and ``mask_head.`` through the two
    SOLOv2 maps."""
    prefix, _, rest = name.partition(".")
    if prefix == "ins_head":
        return ("ins_head",) + map_solov2_ins_torch_name(rest, use_dcn)
    if prefix == "mask_head":
        return ("mask_head",) + map_solov2_mask_torch_name(rest)
    if prefix == "fpn":
        return tuple(name.split("."))
    return map_resnet_torch_name(name)


def map_yolomask_torch_name(name: str) -> Tuple[str, ...]:
    """A key of the port's ``YOLOMask`` -> the flax path of the JAX model:
    ``detector.`` through :func:`map_anchor_yolo_torch_name` on
    CSP-Darknet53, ``orien.`` (the orientation head's ``lat4``, ``lat5``,
    ``conv1``, ``conv2`` BaseConvs and ``orien_pred``) by its flax names."""
    prefix, _, rest = name.partition(".")
    if prefix == "detector":
        return ("detector",) + map_anchor_yolo_torch_name(
            rest, backbone_type="cspdarknet53")
    return tuple(name.split("."))


def map_detr_segm_torch_name(name: str) -> Tuple[str, ...]:
    """A key of the port's ``DETRsegm`` -> the flax path of the JAX model:
    ``bbox_attention.`` (``q_proj``, ``k_proj``) and ``mask_head.``
    (``lay{i}``, ``gn{i}``, ``out_lay``) by their flax names, the rest
    through :func:`map_detr_torch_name`."""
    if name.startswith(("bbox_attention.", "mask_head.")):
        return tuple(name.split("."))
    return map_detr_torch_name(name)


def map_mask_rcnn_torch_name(name: str) -> Tuple[str, ...]:
    """A key of the port's ``MaskRCNN`` or ``PanopticFPNShared`` -> the
    flax path: ``backbone.bottom_up.`` (the ResNet of ``ResNetFPN``)
    through :func:`map_resnet_torch_name` under ``backbone/bottom_up``,
    everything else by its flax name (``backbone.fpn.lateral_0``,
    ``rcnn.box_fc1``, ``sem_seg_head.l1_gn0``)."""
    prefix = "backbone.bottom_up."
    if name.startswith(prefix):
        return ("backbone", "bottom_up") + map_resnet_torch_name(
            "backbone." + name[len(prefix):])[1:]
    return tuple(name.split("."))


def map_flax_named_torch_name(name: str) -> Tuple[str, ...]:
    """A module of the flax name (RegNet, FBNet: the JAX package has no
    reference map for them) -> its path: dots to path parts."""
    return tuple(name.split(".")) if name else ()


def map_mobilevit_torch_name(name: str) -> Tuple[str, ...]:
    """A key of the port's ``MobileViT`` (the flax names) -> its path; an
    attention's ``out_proj`` is flax's ``out``."""
    return _attention_out(map_flax_named_torch_name(name))


def map_fbnet_fpn_torch_name(name: str) -> Tuple[str, ...]:
    """A key of the port's ``FBNetFPN`` (the reference's ``bottom_up`` and
    ``fpn``) -> its flax path: the JAX module holds the trunk as
    ``trunk``."""
    parts = map_flax_named_torch_name(name)
    return ("trunk",) + parts[1:] if parts[:1] == ("bottom_up",) else parts


def map_cspresnet50d_torch_name(name: str) -> Tuple[str, ...]:
    """A key of the port's CSPResNet50d, a bare ResNet-50-vd, -> the flax
    path of the JAX ``ResNet(vd=True)``: :func:`map_resnet_torch_name`."""
    return map_resnet_torch_name(f"backbone.{name}", vd=True)[1:]


# every backbone whose map the models take by ``backbone_type``: the
# transformers, the zoo (``models/backbones/zoo.py``) and the registry's
# backbones that no yaml sets (MobileViT, CSPResNet50d, FBNet with its FPN)
BACKBONE_MAPS = {"swin": map_swin_torch_name,
                 "pvt_v2": map_pvt_v2_torch_name,
                 "convnext": map_convnext_torch_name,
                 "efficientnet": map_efficientnet_torch_name,
                 "regnet": map_flax_named_torch_name,
                 "fbnet": map_flax_named_torch_name,
                 "fbnet_fpn": map_fbnet_fpn_torch_name,
                 "mobilevit": map_mobilevit_torch_name,
                 "cspresnet50d": map_cspresnet50d_torch_name,
                 "dla": map_dla_torch_name}

# Swin's PatchMerging: the reference concatenates the 2x2 neighbours as
# [x0; x1; x2; x3] with x1 = (row + 1, col), x2 = (row, col + 1); the flax
# reshape gives [x0; x2; x1; x3]: flax channel block i is reference block
# _SWIN_MERGE_PERM_BLOCKS[i] (JAX ``weight_port.py:717-729``)
_SWIN_MERGE_PERM_BLOCKS = (0, 2, 1, 3)
_SWIN_MERGE = re.compile(r"(^|\.)layers\.\d+\.downsample\.(norm|reduction)$")


def swin_merge_perm(c4: int) -> np.ndarray:
    """flax channel j of a merging's 4 C reads reference channel
    ``perm[j]`` (an involution)."""
    idx = np.arange(c4).reshape(4, c4 // 4)
    return idx[list(_SWIN_MERGE_PERM_BLOCKS)].reshape(-1)


def map_yolox_kpts_torch_name(name: str,
                             backbone_type: str = "swin") -> Tuple[str, ...]:
    """A key of the port's ``YOLOXKPTS``, or of ``YOLOX`` on another
    backbone than CSPDarknet-X, -> the flax path of the JAX model:
    ``backbone.`` through the map of ``backbone_type`` in
    :data:`BACKBONE_MAPS` (Swin, PVTv2, the zoo) or the YOLOX map
    (CSPDarknet-X); the neck and head through :func:`map_yolox_torch_name`
    (which maps ``head.kpt_convs`` / ``kpt_preds`` too)."""
    prefix, _, rest = name.partition(".")
    if prefix == "backbone" and backbone_type in BACKBONE_MAPS:
        return ("backbone",) + BACKBONE_MAPS[backbone_type](rest)
    return map_yolox_torch_name(name)


_QKV = ("query", "key", "value")
# the transposed convolutions of the port (RepPAN's upsamples, Mask
# R-CNN's mask head)
_CONV_TRANSPOSE = re.compile(r"(^|\.)(upsample_transpose|mask_deconv)$")
# the depthwise transposed convolutions (DLA's bilinear upsamples)
_DEPTHWISE_UP = re.compile(r"(^|\.)up_\d+$")


def dcn_weight_to_flax(weight: np.ndarray) -> np.ndarray:
    """A deformable convolution's fuse weight, torch's ``[O, C, K, K]``
    (the port's, detectron2's and the reference DLA's), -> the JAX
    package's 1x1 kernel over the taps ``[1, 1, K*K*C, O]``, tap-major
    rows (tap t = ky K + kx), as the JAX ``port_dla_state_dict`` does."""
    w = np.asarray(weight)
    o, c, kh, kw = w.shape
    return np.transpose(w, (2, 3, 1, 0)).reshape(1, 1, kh * kw * c, o)


def dcn_weight_from_flax(kernel: np.ndarray, k: int) -> np.ndarray:
    """The inverse of :func:`dcn_weight_to_flax` for a K x K kernel."""
    kern = np.asarray(kernel)
    o = kern.shape[-1]
    return np.transpose(kern.reshape(k, k, -1, o), (3, 2, 0, 1))


def depthwise_up_from_flax(kernel: np.ndarray) -> np.ndarray:
    """The JAX ``BilinearUp`` kernel [k, k, 1, C] (a cross-correlation on
    the dilated input) -> the grouped ``ConvTranspose2d`` weight [C, 1, k,
    k] that computes the same map: spatially flipped."""
    return np.transpose(np.asarray(kernel)[::-1, ::-1], (3, 2, 0, 1))


def conv_transpose_from_flax(kernel: np.ndarray) -> np.ndarray:
    """flax ``ConvTranspose`` kernel [kH, kW, I, O] -> the torch
    ``ConvTranspose2d`` weight [I, O, kH, kW] that computes the same map:
    flax applies the kernel as it is, torch its spatial flip."""
    return np.transpose(np.asarray(kernel)[::-1, ::-1], (2, 3, 0, 1))


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def jax_to_torch_state_dict(
    variables: Mapping[str, Any], template: Mapping[str, Any],
    name_mapper: Callable[[str], Tuple[str, ...]] = map_yolox_torch_name,
) -> Dict[str, np.ndarray]:
    """Map flax ``{"params", "batch_stats"}`` onto the keys and shapes of
    ``template`` (the port's ``state_dict()``, or any mapping of key ->
    array with a ``shape``). ``name_mapper`` turns a torch module name into
    the flax path, as in ``port_torch_state_dict``. Raises ``KeyError`` on a
    key with no flax leaf or a flax leaf that no key took, ``ValueError`` on
    a shape mismatch."""
    trees = {
        "params": _flatten(variables["params"]),
        "batch_stats": _flatten(variables.get("batch_stats", {})),
    }
    taken = set()
    out: Dict[str, np.ndarray] = {}
    params = trees["params"]
    for key, ref in template.items():
        module, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            out[key] = np.zeros((), np.int64)
            continue
        if leaf == "relative_position_index":
            # a buffer the model computes, no flax leaf: kept as it is
            out[key] = np.array(np.asarray(ref), order="C")
            continue
        path = name_mapper(module) if module else ()
        if leaf in ("in_proj_weight", "in_proj_bias"):
            # the q, k, v blocks of a fused projection [3E, E] / [3E]
            part = "kernel" if leaf == "in_proj_weight" else "bias"
            fpaths = [path + (p, part) for p in _QKV]
            missing = [f for f in fpaths if f not in params]
            if missing:
                raise KeyError(f"{key}: no flax leaf at "
                               f"{'/'.join(missing[0])}")
            blocks = [np.asarray(params[f]) for f in fpaths]
            e = blocks[0].shape[0]
            value = np.concatenate([
                b.reshape(e, -1).T if part == "kernel" else b.reshape(-1)
                for b in blocks])
            if tuple(value.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: flax {'/'.join(path)} gives shape "
                                 f"{value.shape}, the port {tuple(ref.shape)}")
            out[key] = np.array(value, order="C")
            taken.update(("params", f) for f in fpaths)
            continue
        if leaf in _STATS_LEAF:
            coll, candidates = "batch_stats", (path + (_STATS_LEAF[leaf],),)
        elif leaf == "weight":
            # an embedding's table is the flax parameter at its path
            coll, candidates = "params", (path + ("kernel",),
                                          path + ("scale",), path)
        elif leaf == "bias":
            coll, candidates = "params", (path + ("bias",),)
        elif leaf == "relative_position_bias_table":
            coll, candidates = "params", (path + ("rel_pos_bias",),)
        else:
            # a raw parameter: a leaf of its own name, or the flax leaf at
            # the module's path (BiFPN's ``edge_weights``)
            coll, candidates = "params", (path + (leaf,), path)
        found = [c for c in candidates if c in trees[coll]]
        if not found:
            raise KeyError(f"{key}: no flax leaf among "
                           f"{['/'.join(c) for c in candidates]}")
        fpath = found[0]
        value = np.asarray(trees[coll][fpath])
        if fpath[-1] == "kernel":
            if value.ndim == 2:
                value = value.T
            elif value.ndim == 3:    # attention's out kernel [H, hd, E]
                value = value.reshape(-1, value.shape[-1]).T
            elif _CONV_TRANSPOSE.search(module):
                value = conv_transpose_from_flax(value)
            elif _DEPTHWISE_UP.search(module):
                value = depthwise_up_from_flax(value)
            elif value.shape[:2] == (1, 1) and tuple(ref.shape[2:]) != (1, 1):
                # a deformable convolution's 1x1 fuse over its K*K taps
                value = dcn_weight_from_flax(value, ref.shape[-1])
            else:
                value = np.transpose(value, (3, 2, 0, 1))
        if _SWIN_MERGE.search(module):
            # a merging's channels into the reference's block order
            perm = swin_merge_perm(value.shape[-1])
            value = value[..., perm]
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax {'/'.join(fpath)} has shape "
                             f"{value.shape}, the port {tuple(ref.shape)}")
        out[key] = np.array(value, order="C")  # a writable copy
        taken.add((coll, fpath))
    left = [f"{coll}/{'/'.join(p)}" for coll, tree in trees.items()
            for p in tree if (coll, p) not in taken]
    if left:
        raise KeyError(f"flax leaves with no port key: {left[:20]}")
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a reference-format ``.pth``/``.pt``/``.pkl``
    checkpoint on the CPU (JAX ``utils/weight_port.py:422``): unwraps
    ``"model"`` and ``"state_dict"``. Its keys are the reference's module
    names, which are the port's, so it loads straight into the port's
    model."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for k, v in obj.items()}
