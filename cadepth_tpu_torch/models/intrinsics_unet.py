"""The intrinsics-conditioned U-Nets (port of
``cadepth_tpu.models.intrinsics_unet``).

The baseline's topology with a FiLM-conditioned DoubleConv in every
block (FiLM between the two convs). The [fx, fy, cx, cy] vector is
normalised once a forward and fed to all nine blocks. The attention
variant adds a CBAM after each decoder block (``att4`` .. ``att1``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cadepth_tpu_torch.geometry.intrinsics import normalize_k4
from cadepth_tpu_torch.models.attention import CBAM
from cadepth_tpu_torch.models.geometry_aware import RayEnhancedConv
from cadepth_tpu_torch.models.layers import (Conv2d, DepthUNet,
                                             pad_to_match, upsample2x)

Intermediates = Optional[Dict[str, List[torch.Tensor]]]


class FiLMDoubleConv(RayEnhancedConv):
    """Conv -> norm -> ReLU -> FiLM -> Conv -> norm -> ReLU: the
    geometry network's RayEnhancedConv called without rays (the same
    modules and names)."""


class FiLMEncoderBlock(nn.Module):
    """MaxPool2 -> FiLMDoubleConv."""

    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch"):
        super().__init__()
        self.conv = FiLMDoubleConv(in_channels, features, dtype, norm)

    def forward(self, x: torch.Tensor,
                camera_params: torch.Tensor) -> torch.Tensor:
        return self.conv(F.max_pool2d(x, 2), camera_params)


class FiLMDecoderBlock(nn.Module):
    """2x upsampling -> pad to the skip -> concat [skip, x] ->
    FiLMDoubleConv."""

    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch",
                 upsample: str = "transpose"):
        super().__init__()
        self.up = upsample2x(in_channels, features, upsample, dtype)
        self.conv = FiLMDoubleConv(2 * features, features, dtype, norm)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                camera_params: torch.Tensor) -> torch.Tensor:
        x = pad_to_match(self.up(x), skip)
        return self.conv(torch.cat([skip, x.to(skip.dtype)], dim=1),
                         camera_params)


class IntrinsicsConditionedUNet(DepthUNet):
    """FiLM-everywhere U-Net.

    ``forward(rgb, camera_intrinsics, intermediates=None)``: NHWC rgb
    (B, H, W, 3) and [fx, fy, cx, cy] (B, 4) in pixels -> (B, H, W, 1)
    float32 depth in metres. ``intermediates`` is taken so every family
    has one call signature; nothing is written to it. Any H and W of at
    least 16 work (the decoder pads a pooled odd row or column back,
    ``layers.pad_to_match``); under spatial parallelism the input is a
    band of H / S rows, with the band rule of ``models/layers.py``.
    """

    def __init__(self, in_channels: int = 3, init_features: int = 64,
                 camera_dim: int = 4, max_depth: float = 10.0, remat=False,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch",
                 decoder_upsample: str = "transpose"):
        super().__init__(dtype, max_depth, remat, camera_dim)
        f = init_features
        self.enc1 = FiLMDoubleConv(in_channels, f, dtype, norm)
        for i in (2, 3, 4):
            setattr(self, f"enc{i}",
                    FiLMEncoderBlock(f << (i - 2), f << (i - 1), dtype, norm))
        self.bottleneck = FiLMEncoderBlock(f * 8, f * 16, dtype, norm)
        for i in (4, 3, 2, 1):
            setattr(self, f"dec{i}", FiLMDecoderBlock(
                f << i, f << (i - 1), dtype, norm, decoder_upsample))
        self.out_conv = Conv2d(f, 1, 1, dtype=torch.float32)

    def _attend(self, level: int, x: torch.Tensor) -> torch.Tensor:
        return x

    def forward(self, rgb: torch.Tensor, camera_intrinsics: torch.Tensor,
                intermediates: Intermediates = None) -> torch.Tensor:
        h, w = self._height(rgb), rgb.shape[2]
        cam = normalize_k4(camera_intrinsics.float(), width=w, height=h)
        banded = [self.space is not None]
        with self._on(banded[0]):
            skips = [self._block("enc1", self._nchw(rgb, self.dtype), cam)]
        for i in (2, 3, 4):
            x, b = self._encode(f"enc{i}", skips[-1], banded[-1], cam)
            skips.append(x)
            banded.append(b)
        x, b = self._encode("bottleneck", skips[-1], banded[-1], cam)
        for i in (4, 3, 2, 1):
            x, b = self._decode(f"dec{i}", x, b, skips[i - 1], banded[i - 1],
                                cam)
            with self._on(b):
                x = self._attend(i, x)
        return self._depth(x)


class IntrinsicsAttentionUNet(IntrinsicsConditionedUNet):
    """:class:`IntrinsicsConditionedUNet` with a CBAM (``att4`` ..
    ``att1``) after each decoder block; ``sa_lowering`` as the flagship's
    (one conv on the GPU whatever its value)."""

    def __init__(self, in_channels: int = 3, init_features: int = 64,
                 camera_dim: int = 4, max_depth: float = 10.0, remat=False,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch",
                 decoder_upsample: str = "transpose",
                 sa_lowering: str = "toeplitz"):
        super().__init__(in_channels, init_features, camera_dim, max_depth,
                         remat, dtype, norm, decoder_upsample)
        for i in (4, 3, 2, 1):
            setattr(self, f"att{i}", CBAM(init_features << (i - 1),
                                          dtype=dtype,
                                          sa_lowering=sa_lowering))

    def _attend(self, level: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"att{level}")(x)
