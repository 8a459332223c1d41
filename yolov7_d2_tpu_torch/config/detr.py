"""The configuration of DETR and its variants (``MODEL.DETR``,
``MODEL.RESNETS.DEPTH``): DETR, AnchorDETR, SMCA-DETR, DAB-DETR and the
d2go DETR.

``DetrConfig`` subclasses ``YoloxConfig``, so that the optimizer (AdamW
with ``BACKBONE_MULTIPLIER``), the schedule and the trainer read the shared
fields unchanged. Its defaults are ``configs/coco/detr/
detr_256_6_6_r50.yaml`` merged into the default tree. ``from_cfg`` reads
what the JAX builders (``models/meta_arch/detr.py:335``,
``detr_variants.py:505-704``) and ``engine.build_system`` (:263-279)
read: the ResNet is always FrozenBN with the stride on the 3x3, whatever
``MODEL.RESNETS`` says besides its depth; AnchorDETR reads an
``ATTENTION_TYPE`` other than ``nn.MultiheadAttention`` as RCDA, the d2go
DETR one other than ``SMCA`` as DETR (``d2go_attention``); the d2go
DETR's zoo backbone reads ``zoo``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from yolov7_d2_tpu_torch.config.yolox import YoloxConfig

DETR_ARCHS = ("Detr", "AnchorDetr", "SMCADetr", "DABDetr", "DetrD2go")


@dataclasses.dataclass(frozen=True)
class DetrConfig(YoloxConfig):
    """Defaults: DETR R-50 at 800 (6 + 6 layers, 100 queries, 80 classes),
    bf16 over f32 weights, AdamW at lr 1e-4 with the backbone at 0.1 of
    it, no EMA."""

    meta_architecture: str = "Detr"
    backbone: str = "build_resnet_backbone"
    input_size: Tuple[int, int] = (800, 800)
    resnet_depth: int = 50
    hidden_dim: int = 256
    num_queries: int = 100
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1
    pre_norm: bool = False
    # MODEL.DETR.REMAT: each encoder and decoder layer recomputed in the
    # backward (``models/layers/transformer.py``); ``remat``, read from
    # TPU.REMAT, recomputes the whole forward
    layer_remat: bool = False
    # AnchorDETR
    num_query_position: int = 300
    num_query_pattern: int = 3
    spatial_prior: str = "learned"     # learned | grid
    attention_type: str = "RCDA"       # RCDA | nn.MultiheadAttention
    # the d2go DETR: its reading of ATTENTION_TYPE, the centred embedding
    d2go_attention: str = "DETR"       # SMCA | DETR
    centered_pe: bool = False
    # the criterion
    use_focal_loss: bool = False
    deep_supervision: bool = True
    no_object_weight: float = 0.1
    optimizer: str = "adamw"
    base_lr: float = 1e-4
    backbone_multiplier: float = 0.1
    max_iter: int = 554400
    ema: bool = False

    @property
    def use_focal(self) -> bool:
        """The sigmoid-focal criterion (JAX ``engine.py:265``): AnchorDETR
        always, DETR where ``USE_FOCAL_LOSS``."""
        return self.use_focal_loss or self.meta_architecture == "AnchorDetr"

    @classmethod
    def from_cfg(cls, cfg) -> "DetrConfig":
        """Read the fields from a merged ``CfgNode``."""
        base = YoloxConfig.from_cfg(cfg)
        d = cfg.MODEL.DETR
        return cls(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(YoloxConfig)
               if f.name != "num_classes"},
            num_classes=int(d.NUM_CLASSES),
            resnet_depth=int(cfg.MODEL.RESNETS.DEPTH),
            hidden_dim=int(d.HIDDEN_DIM),
            num_queries=int(d.NUM_OBJECT_QUERIES),
            nheads=int(d.NHEADS),
            enc_layers=int(d.ENC_LAYERS),
            dec_layers=int(d.DEC_LAYERS),
            dim_feedforward=int(d.DIM_FEEDFORWARD),
            dropout=float(d.DROPOUT),
            pre_norm=bool(d.PRE_NORM),
            layer_remat=bool(d.REMAT),
            num_query_position=int(d.NUM_QUERY_POSITION),
            num_query_pattern=int(d.NUM_QUERY_PATTERN),
            spatial_prior=str(d.SPATIAL_PRIOR),
            attention_type=("nn.MultiheadAttention"
                            if d.ATTENTION_TYPE == "nn.MultiheadAttention"
                            else "RCDA"),
            d2go_attention="SMCA" if d.ATTENTION_TYPE == "SMCA" else "DETR",
            centered_pe=bool(d.CENTERED_POSITION_ENCODIND),
            use_focal_loss=bool(d.USE_FOCAL_LOSS),
            deep_supervision=bool(d.DEEP_SUPERVISION),
            no_object_weight=float(d.NO_OBJECT_WEIGHT),
        )
