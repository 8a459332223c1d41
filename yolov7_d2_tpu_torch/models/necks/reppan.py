"""YOLOv6's RepPAN neck and the PP-YOLO PAN neck (JAX
``models/necks/reppan.py``).

``RepPANNeck`` keeps the original reference's module names
(``reduce_layer0``, ``upsample0.upsample_transpose``, ``Rep_p4`` ...), so
that ``utils/weight_port.py:map_reppan_torch_name`` applies. Its two
upsamples are learnable transposed convolutions, k 2, stride 2; the port's
``ConvTranspose2d`` holds flax's ``ConvTranspose`` kernel flipped in both
spatial axes (the weight carrier flips it). ``PPYOLOPAN`` keeps the flax
module names of the JAX package (no reference checkpoint names exist for
it). BatchNorm eps 1e-3, torch momentum 0.03.

``DropBlock`` draws its seeds from the neck's ``generator`` (a
``torch.Generator`` on the model's device, which the builder sets and the
training step reseeds from the seed and the step); its masks cannot equal
the JAX package's, which draw from a flax RNG stream.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.models.backbones.efficientrep import (
    RepBlock,
    make_divisible,
    scaled_repeats,
)
from yolov7_d2_tpu_torch.models.layers.blocks import BaseConv, SPPBottleneck
from yolov7_d2_tpu_torch.models.necks.yolo_pafpn import upsample2x_nearest


class Transpose(nn.Module):
    """The reference's learnable 2x upsample: ``upsample_transpose``, a
    ``ConvTranspose2d`` k 2, stride 2, with bias."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.upsample_transpose = nn.ConvTranspose2d(
            in_channels, out_channels, 2, 2, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.upsample_transpose(x)


class RepPANNeck(nn.Module):
    """Top-down then bottom-up PAN of RepBlocks over strides 8/16/32; the
    channel plan is the reference's indices 5..10, each
    ``make_divisible(c * width_mul)`` (JAX :27). ``feat_channels`` are the
    backbone's (erep3, erep4, erep5)."""

    channels_plan = (256, 128, 128, 256, 256, 512)
    repeats_plan = (12, 12, 12, 12)

    def __init__(self, feat_channels: Sequence[int], width_mul: float = 1.0,
                 depth_mul: float = 1.0):
        super().__init__()
        f2, f1, f0 = feat_channels
        ch5, ch6, ch7, ch8, ch9, ch10 = [make_divisible(c * width_mul)
                                         for c in self.channels_plan]
        reps = scaled_repeats(self.repeats_plan, depth_mul)
        self.reduce_layer0 = BaseConv(f0, ch5, 1, 1, act="relu")
        self.upsample0 = Transpose(ch5, ch5)
        self.Rep_p4 = RepBlock(ch5 + f1, ch5, reps[0])
        self.reduce_layer1 = BaseConv(ch5, ch6, 1, 1, act="relu")
        self.upsample1 = Transpose(ch6, ch6)
        self.Rep_p3 = RepBlock(ch6 + f2, ch6, reps[1])
        self.downsample2 = BaseConv(ch6, ch7, 3, 2, act="relu")
        self.Rep_n3 = RepBlock(ch7 + ch6, ch8, reps[2])
        self.downsample1 = BaseConv(ch8, ch9, 3, 2, act="relu")
        self.Rep_n4 = RepBlock(ch9 + ch5, ch10, reps[3])
        self.out_channels = (ch6, ch8, ch10)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x2, x1, x0 = feats
        r0 = self.reduce_layer0(x0)
        p4 = self.Rep_p4(torch.cat([self.upsample0(r0), x1], 1))
        r1 = self.reduce_layer1(p4)
        p3 = self.Rep_p3(torch.cat([self.upsample1(r1), x2], 1))
        n4 = self.Rep_n3(torch.cat([self.downsample2(p3), r1], 1))
        n5 = self.Rep_n4(torch.cat([self.downsample1(n4), r0], 1))
        return p3, n4, n5


class DropBlock(nn.Module):
    """DropBlock2D (JAX :95): in train mode with ``keep_prob`` < 1, seeds
    at rate gamma (so that the expected dropped share is ``1 - keep_prob``)
    grow into ``block_size`` squares of zeros, and the rest is scaled by
    the share kept; identity otherwise. The seeds come from ``generator``."""

    def __init__(self, block_size: int = 3, keep_prob: float = 0.9):
        super().__init__()
        self.block_size = block_size
        self.keep_prob = keep_prob

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.keep_prob >= 1.0:
            return x
        if generator is None:
            raise ValueError("DropBlock in train mode draws from an explicit "
                             "torch.Generator; none was given")
        b, _, h, w = x.shape
        bs = min(self.block_size, h, w)
        gamma = ((1.0 - self.keep_prob) / (bs * bs) * (h * w)
                 / max((h - bs + 1) * (w - bs + 1), 1))
        seeds = (torch.rand((b, 1, h, w), generator=generator,
                            device=x.device) < gamma).float()
        lo, hi = bs // 2, (bs - 1) // 2
        block = F.max_pool2d(F.pad(seeds, (lo, hi, lo, hi)), bs, stride=1)
        mask = 1.0 - block
        scale = mask.numel() / mask.sum().clamp(min=1.0)
        return x * (mask * scale).to(x.dtype)


class PPYOLOPAN(nn.Module):
    """PP-YOLOv2's PAN (JAX :127): leaky-ReLU conv blocks, SPP on the
    deepest level, DropBlock after each top-down output, drawing from
    ``generator``; returns (p3, p4, p5) at ``channels``. ``feat_channels``
    are the backbone's."""

    def __init__(self, feat_channels: Sequence[int],
                 channels: Sequence[int] = (128, 256, 512),
                 with_spp: bool = True, keep_prob: float = 0.9):
        super().__init__()
        f2, f1, f0 = feat_channels
        c3, c4, c5 = channels
        act = "lrelu"
        self.p5_in = BaseConv(f0, c5, 1, 1, act=act)
        self.spp = SPPBottleneck(c5, c5, act=act) if with_spp else None
        self.p5_out = BaseConv(c5, c5, 3, 1, act=act)
        self.lat1 = BaseConv(c5, c4, 1, 1, act=act)
        self.p4_out = BaseConv(c4 + f1, c4, 3, 1, act=act)
        self.lat2 = BaseConv(c4, c3, 1, 1, act=act)
        self.p3_out = BaseConv(c3 + f2, c3, 3, 1, act=act)
        self.pan_down2 = BaseConv(c3, c4, 3, 2, act=act)
        self.pan_p4 = BaseConv(2 * c4, c4, 3, 1, act=act)
        self.pan_down1 = BaseConv(c4, c5, 3, 2, act=act)
        self.pan_p5 = BaseConv(2 * c5, c5, 3, 1, act=act)
        self.drops = nn.ModuleList(DropBlock(keep_prob=keep_prob)
                                   for _ in range(3))
        self.out_channels = tuple(channels)
        self.generator: Optional[torch.Generator] = None

    def _drop(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return self.drops[i](x, self.generator)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x2, x1, x0 = feats
        y0 = self.p5_in(x0)
        if self.spp is not None:
            y0 = self.spp(y0)
        y0 = self._drop(0, self.p5_out(y0))
        y1 = self._drop(1, self.p4_out(torch.cat(
            [upsample2x_nearest(self.lat1(y0)), x1], 1)))
        y2 = self._drop(2, self.p3_out(torch.cat(
            [upsample2x_nearest(self.lat2(y1)), x2], 1)))
        z1 = self.pan_p4(torch.cat([self.pan_down2(y2), y1], 1))
        z0 = self.pan_p5(torch.cat([self.pan_down1(z1), y0], 1))
        return y2, z1, z0
