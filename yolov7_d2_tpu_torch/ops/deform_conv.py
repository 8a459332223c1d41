"""Deformable convolution, v2 (modulated) and v1 (JAX ``ops/deform_conv.py``).

A regular 3x3 convolution (``offset_conv``, zero-initialised: at init every
offset is 0 and every modulation sigmoid(0) = 0.5) predicts, at each output
position, a (dy, dx) offset for each of the K*K taps (tap-major channels:
2t is tap t's dy, 2t + 1 its dx) and, for v2, one modulation logit a tap
(channels 2 K*K + t). Each tap samples the input bilinearly at its grid
point plus its offset, in float32, every corner outside the image counting
as zero; v2 scales the sample by the sigmoid of its logit. The K*K taps
then go through one 1x1 convolution over their K*K*C channels, in the
compute dtype: the K x K kernel reshaped.

The sampling is one ``F.grid_sample`` call a layer (bilinear, zero padding,
``align_corners=False``) over all K*K taps at once: the taps' sample grids
are stacked along the image's height. The JAX package takes four gathers
and a lerp a tap; the two compute the same bilinear weights up to float32
rounding (the pixel coordinate goes through grid_sample's normalized one).
``F.grid_sample``'s CUDA backward adds into the input gradient with
atomics, so two runs of a training step would differ in the last bits
there (ROADMAP.md C.14): the sampling goes through :data:`grid_sample`,
``ops/fixed_order.grid_sample_fixed_order``, the same forward with an
input gradient summed in a fixed order (``tools/step_repeat.py --dcn``
swaps in ``F.grid_sample`` to time the two).

The fuse weight keeps torch's ``[O, C, K, K]`` layout (detectron2's and the
reference DLA's ``ModulatedDeformConv``); ``utils/weight_port.py`` turns it
into the JAX package's ``[1, 1, K*K*C, O]`` tap-major 1x1 kernel and back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from yolov7_d2_tpu_torch.ops.fixed_order import grid_sample_fixed_order

# the sampling op of :func:`bilinear_sample`: F.grid_sample's forward with
# the fixed-order input gradient
grid_sample = grid_sample_fixed_order

def _float32(device: torch.device):
    """A region outside autocast: the sampling runs in float32."""
    return torch.autocast(device.type, enabled=False)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``img`` [B, C, H, W] at the pixel coordinates
    ``x``, ``y`` [B, H', W'] (JAX :29), zero outside the image, in float32
    -> [B, C, H', W']."""
    _, _, h, w = img.shape
    grid = torch.stack([(2.0 * x.float() + 1.0) / w - 1.0,
                        (2.0 * y.float() + 1.0) / h - 1.0], -1)
    with _float32(img.device):
        return grid_sample(img.float(), grid)


def deform_sample_taps(x: torch.Tensor, offsets: torch.Tensor,
                       kernel: int = 3,
                       modulation: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The K*K deformed taps of ``x`` [B, C, H, W] (JAX :60): ``offsets``
    [B, 2 K*K, H, W] ((dy, dx) a tap, tap-major), ``modulation`` [B, K*K,
    H, W] logits (v2) or None -> float32 [B, C, K*K, H, W], tap t = ky K +
    kx at grid offset (ky - K // 2, kx - K // 2)."""
    b, c, h, w = x.shape
    k2 = kernel * kernel
    half = (kernel - 1) // 2
    dev = x.device
    taps = torch.arange(k2, device=dev)
    dy = (taps // kernel - half).float()[None, :, None, None]
    dx = (taps % kernel - half).float()[None, :, None, None]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    off = offsets.float().reshape(b, k2, 2, h, w)
    sy = (gy + dy) + off[:, :, 0]                        # [B, K*K, H, W]
    sx = (gx + dx) + off[:, :, 1]
    # every tap's grid stacked along the height: one sampling call
    out = bilinear_sample(x, sx.reshape(b, k2 * h, w),
                          sy.reshape(b, k2 * h, w)).reshape(b, c, k2, h, w)
    if modulation is not None:
        out = out * torch.sigmoid(modulation.float())[:, None]
    return out


class ModulatedDeformConv2d(nn.Conv2d):
    """The deformable convolution's fuse over sampled taps: ``weight``
    [O, C, K, K] and ``bias`` [O] of a K x K convolution (stride 1, "same"
    padding), applied as the 1x1 convolution over the K*K taps that the
    JAX package's ``weight`` layer is. ``forward(x, raw)`` takes the
    offset convolution's output ``raw`` [B, (3 if modulated else 2) K*K,
    H, W]."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3,
                 modulated: bool = True):
        super().__init__(c_in, c_out, kernel, 1, (kernel - 1) // 2,
                         bias=True)
        self.modulated = modulated

    def forward(self, x: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size[0]
        k2 = k * k
        b, c, h, w = x.shape
        with _float32(x.device):
            taps = deform_sample_taps(
                x, raw[:, :2 * k2], k,
                raw[:, 2 * k2:] if self.modulated else None)
        # [B, C, K*K, H, W] -> [B, C K*K, H, W]: the weight's own order
        return F.conv2d(taps.reshape(b, c * k2, h, w),
                        self.weight.reshape(self.out_channels, c * k2, 1, 1),
                        self.bias)


class DeformConv(ModulatedDeformConv2d):
    """The JAX ``DeformConv`` block (:88): ``offset_conv`` (3x3 with bias,
    zero-initialised, run in float32 on the float32 input) and the fuse.
    ``init_fixed_`` restores the zero offset init after a random draw of
    every convolution (``models/build.init_weights_``)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3,
                 modulated: bool = True):
        super().__init__(c_in, c_out, kernel, modulated)
        self.offset_conv = nn.Conv2d(
            c_in, kernel * kernel * (3 if modulated else 2), kernel, 1,
            (kernel - 1) // 2)
        self.init_fixed_()

    @torch.no_grad()
    def init_fixed_(self) -> None:
        self.offset_conv.weight.zero_()
        self.offset_conv.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _float32(x.device):
            raw = self.offset_conv(x.float())
        return super().forward(x, raw)
