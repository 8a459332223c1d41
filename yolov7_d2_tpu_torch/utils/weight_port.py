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
channel order into the reference's (``swin_merge_perm``). The flax tree is
nested dicts of numpy arrays, so no JAX is needed here.
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
    ``cspdarknet53``, ``cspdarknetx``, ``resnet``, ``resnet_vd``, ``swin``
    or ``pvt_v2``, whose names overlap, so the caller says which),
    ``neck.`` through the YOLOFPN map or the YOLOX one (YOLOPAFPN),
    ``head.towers.{l}`` -> ``head/tower_{l}`` and ``head.preds.{l}`` ->
    ``head/pred_{l}``."""
    prefix, _, rest = name.partition(".")
    if prefix == "backbone":
        if backbone_type in TRANSFORMER_MAPS:
            return ("backbone",) + TRANSFORMER_MAPS[backbone_type](rest)
        if backbone_type in ("resnet", "resnet_vd"):
            return map_resnet_torch_name(name, backbone_type == "resnet_vd")
        if backbone_type == "cspdarknetx":
            return map_yolox_torch_name(name)
        mapper = (map_cspdarknet_torch_name
                  if backbone_type == "cspdarknet53"
                  else map_darknet_torch_name)
        return ("backbone",) + mapper(rest)
    if prefix == "neck":
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
    vd stem, whose ``stem.conv{k}`` are the flax ``stem{k}``."""
    m = re.match(r"^backbone\.stem\.conv(\d)(\.norm)?$", name)
    if vd and m:
        return ("backbone", f"stem{m.group(1)}",
                "bn" if m.group(2) else "conv")
    return map_d2_resnet_name(name)


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


# the transformer backbones' maps, by the models' ``backbone_type``
TRANSFORMER_MAPS = {"swin": map_swin_torch_name,
                    "pvt_v2": map_pvt_v2_torch_name}

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
    """A key of the port's ``YOLOXKPTS`` -> the flax path of the JAX model:
    ``backbone.`` through :func:`map_swin_torch_name`,
    :func:`map_pvt_v2_torch_name` or the YOLOX map (CSPDarknet-X), as
    ``backbone_type`` says; the neck and head through
    :func:`map_yolox_torch_name` (which maps ``head.kpt_convs`` /
    ``kpt_preds`` too)."""
    prefix, _, rest = name.partition(".")
    if prefix == "backbone" and backbone_type in TRANSFORMER_MAPS:
        return ("backbone",) + TRANSFORMER_MAPS[backbone_type](rest)
    return map_yolox_torch_name(name)


_QKV = ("query", "key", "value")


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
            coll, candidates = "params", (path + (leaf,),)
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
