"""YOLOX decoupled head and grid decode (JAX ``models/heads/yolox_head.py``
:32-121). Serving only: SimOTA and the losses are not ported yet.

Module names follow the original reference (``stems.l``, ``cls_convs.l.i``,
``reg_convs.l.i``, ``{cls,reg,obj}_preds.l``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from yolov7_d2_tpu_torch.models.layers.blocks import BaseConv, conv_class

WH_LOGIT_MAX = 11.09  # exp clamp of the JAX decode (yolox_head.py:119)


class YOLOXHead(nn.Module):
    def __init__(self, num_classes: int = 80, width: float = 1.0,
                 strides: Sequence[int] = (8, 16, 32),
                 in_channels: Sequence[int] = (256, 512, 1024),
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        self.strides = tuple(strides)
        hidden = int(256 * width)
        conv = conv_class(depthwise)

        def tower():
            return nn.Sequential(conv(hidden, hidden, 3, 1, act=act),
                                 conv(hidden, hidden, 3, 1, act=act))

        self.stems = nn.ModuleList(
            BaseConv(int(c * width), hidden, 1, 1, act=act)
            for c in in_channels
        )
        self.cls_convs = nn.ModuleList(tower() for _ in in_channels)
        self.reg_convs = nn.ModuleList(tower() for _ in in_channels)
        self.cls_preds = nn.ModuleList(
            nn.Conv2d(hidden, num_classes, 1) for _ in in_channels)
        self.reg_preds = nn.ModuleList(
            nn.Conv2d(hidden, 4, 1) for _ in in_channels)
        self.obj_preds = nn.ModuleList(
            nn.Conv2d(hidden, 1, 1) for _ in in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """feats: per-level features, strides 8/16/32.

        Returns ``outputs`` [B, A, 5 + C] raw (tx, ty, tw, th, obj, cls...)
        in the compute dtype, ``grids`` [A, 2] f32 cell (x, y), ``strides``
        [A] f32; anchors row-major per level, level-major overall.
        """
        outputs, grids, strides = [], [], []
        for lvl, (x, stride) in enumerate(zip(feats, self.strides)):
            x = self.stems[lvl](x)
            c = self.cls_convs[lvl](x)
            r = self.reg_convs[lvl](x)
            out = torch.cat([self.reg_preds[lvl](r), self.obj_preds[lvl](r),
                             self.cls_preds[lvl](c)], dim=1)
            b, ch, h, w = out.shape
            outputs.append(out.permute(0, 2, 3, 1).reshape(b, h * w, ch))
            ys, xs = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=out.device),
                torch.arange(w, dtype=torch.float32, device=out.device),
                indexing="ij",
            )
            grids.append(torch.stack([xs, ys], dim=-1).reshape(h * w, 2))
            strides.append(torch.full((h * w,), float(stride),
                                      dtype=torch.float32, device=out.device))
        return {
            "outputs": torch.cat(outputs, dim=1),
            "grids": torch.cat(grids, dim=0),
            "strides": torch.cat(strides, dim=0),
        }


def decode_outputs(
    outputs: torch.Tensor, grids: torch.Tensor, strides: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw outputs -> (boxes cxcywh [.., A, 4], obj logits [.., A], cls
    logits [.., A, C]) in input pixels, f32."""
    outputs = outputs.float()
    xy = (outputs[..., 0:2] + grids) * strides[..., None]
    wh = torch.exp(outputs[..., 2:4].clamp(max=WH_LOGIT_MAX)) \
        * strides[..., None]
    return torch.cat([xy, wh], dim=-1), outputs[..., 4], outputs[..., 5:]
