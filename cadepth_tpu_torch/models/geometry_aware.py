"""The geometry-aware depth networks (port of
``cadepth_tpu.models.geometry_aware``): the full variant and the
lightweight one.

Ray-direction input channels, FiLM conditioning in every conv block,
Perspective Correction Layers in the decoder and CBAM attention. The
full network has five encoder levels to a 32f bottleneck and five
decoder levels back; the lightweight one four levels to a 16f
bottleneck, with attention and a PCL on every level.

Only ``enc1`` reads the rays. The JAX decoder pools rays for each level
and hands them to the PCL, which ignores them, so the port does not pool
them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cadepth_tpu_torch.geometry.intrinsics import normalize_k4
from cadepth_tpu_torch.models.attention import CBAM
from cadepth_tpu_torch.models.film import FiLMLayer
from cadepth_tpu_torch.models.layers import (Conv2d, DepthUNet, apply_norm,
                                             make_norm, pad_to_match,
                                             upsample2x)
from cadepth_tpu_torch.models.pcl import PerspectiveCorrectionLayer

Intermediates = Optional[Dict[str, List[torch.Tensor]]]


class RayEnhancedConv(nn.Module):
    """[x; rays] -> conv-BN-ReLU -> FiLM -> conv-BN-ReLU."""

    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch"):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(in_channels, features, 3, padding=1, bias=False,
                            dtype=dtype)
        self.bn1 = make_norm(norm, features)
        self.film = FiLMLayer(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False,
                            dtype=dtype)
        self.bn2 = make_norm(norm, features)

    def forward(self, x: torch.Tensor, camera_params: torch.Tensor,
                ray_directions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if ray_directions is not None:
            x = torch.cat([x, ray_directions.to(x.dtype)], dim=1)
        x = F.relu(apply_norm(self.conv1(x), self.bn1, self.dtype))
        x = self.film(x, camera_params)
        return F.relu(apply_norm(self.conv2(x), self.bn2, self.dtype))


class GeometryEncoderBlock(nn.Module):
    """MaxPool -> RayEnhancedConv -> optional CBAM."""

    def __init__(self, in_channels: int, features: int,
                 use_attention: bool = True,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch",
                 sa_lowering: str = "toeplitz"):
        super().__init__()
        self.conv = RayEnhancedConv(in_channels, features, dtype, norm)
        self.attention = (CBAM(features, dtype=dtype, sa_lowering=sa_lowering)
                          if use_attention else None)

    def forward(self, x: torch.Tensor,
                camera_params: torch.Tensor) -> torch.Tensor:
        x = self.conv(F.max_pool2d(x, 2), camera_params)
        if self.attention is not None:
            x = self.attention(x)
        return x


class GeometryDecoderBlock(nn.Module):
    """UpConv -> PCL -> pad -> concat [skip, x] -> RayEnhancedConv -> CBAM."""

    def __init__(self, in_channels: int, features: int, use_pcl: bool = True,
                 use_attention: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 pcl_warp: str = "two_pass", norm: str = "batch",
                 upsample: str = "transpose", sa_lowering: str = "toeplitz"):
        super().__init__()
        self.up = upsample2x(in_channels, features, upsample, dtype)
        self.pcl = (PerspectiveCorrectionLayer(features, warp_mode=pcl_warp)
                    if use_pcl else None)
        self.conv = RayEnhancedConv(2 * features, features, dtype, norm)
        self.attention = (CBAM(features, dtype=dtype, sa_lowering=sa_lowering)
                          if use_attention else None)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                camera_params: torch.Tensor,
                intermediates: Intermediates = None) -> torch.Tensor:
        # the warp kernel takes the NHWC view of a channels_last map
        x = self.up(x).contiguous(memory_format=torch.channels_last)
        if self.pcl is not None:
            x = self.pcl(x, camera_params, intermediates)
        x = pad_to_match(x, skip)
        x = torch.cat([skip, x.to(skip.dtype)], dim=1)
        x = self.conv(x, camera_params)
        if self.attention is not None:
            x = self.attention(x)
        return x


class _GeometryUNet(DepthUNet):
    """``levels`` encoder levels (``enc1`` a RayEnhancedConv over [rgb;
    rays], then encoder blocks), a bottleneck at ``2**levels`` f, and
    ``levels`` decoder blocks back, each with a PCL when ``use_pcl``."""

    def __init__(self, levels: int, in_channels: int, init_features: int,
                 camera_dim: int, max_depth: float, use_pcl: bool,
                 use_attention: bool, dtype: torch.dtype, pcl_warp: str,
                 norm: str, decoder_upsample: str, sa_lowering: str, remat):
        super().__init__(dtype, max_depth, remat, camera_dim)
        f = init_features
        self.levels = levels
        enc = dict(use_attention=use_attention, dtype=dtype, norm=norm,
                   sa_lowering=sa_lowering)
        dec = dict(use_pcl=use_pcl, pcl_warp=pcl_warp,
                   upsample=decoder_upsample, **enc)
        self.enc1 = RayEnhancedConv(in_channels + 3, f, dtype, norm)
        for i in range(2, levels + 1):
            setattr(self, f"enc{i}",
                    GeometryEncoderBlock(f << (i - 2), f << (i - 1), **enc))
        self.bottleneck = GeometryEncoderBlock(f << (levels - 1),
                                               f << levels, **enc)
        for i in range(levels, 0, -1):
            setattr(self, f"dec{i}",
                    GeometryDecoderBlock(f << i, f << (i - 1), **dec))
        self.out_conv = Conv2d(f, 1, 1, dtype=torch.float32)

    def forward(self, rgb: torch.Tensor, ray_directions: torch.Tensor,
                camera_intrinsics: torch.Tensor,
                intermediates: Intermediates = None) -> torch.Tensor:
        """When ``intermediates`` is a dict, each PCL appends its max
        |rotation| to ``intermediates["pcl_max_rot"]``."""
        h, w = self._height(rgb), rgb.shape[2]
        cam = normalize_k4(camera_intrinsics.float(), width=w, height=h)
        x = self._nchw(rgb, self.dtype)
        rays = self._nchw(ray_directions, ray_directions.dtype)

        banded = [self.space is not None]
        with self._on(banded[0]):
            skips = [self._block("enc1", x, cam, rays)]
        for i in range(2, self.levels + 1):
            x, b = self._encode(f"enc{i}", skips[-1], banded[-1], cam)
            skips.append(x)
            banded.append(b)
        x, b = self._encode("bottleneck", skips[-1], banded[-1], cam)
        for i in range(self.levels, 0, -1):
            x, b = self._decode(f"dec{i}", x, b, skips[i - 1],
                                banded[i - 1], cam, intermediates)
        return self._depth(x)


class GeometryAwareNetwork(_GeometryUNet):
    """Full 5-level geometry-aware network.

    ``forward`` takes NHWC rgb (B, H, W, 3), ray_directions (B, H, W, 3)
    and camera_intrinsics (B, 4) in pixels, and returns depth in metres,
    (B, H, W, 1) float32. Any H and W of at least 32 work: each 2x2 pool
    drops an odd row or column and the decoder pads it back
    (``layers.pad_to_match``), so 240 rows pool to 120, 60, 30, 15 and 7.
    Under spatial parallelism (``space``) the inputs are bands of H / S
    rows and the levels follow the band rule of ``models/layers.py``.
    """

    def __init__(self, in_channels: int = 3, init_features: int = 64,
                 camera_dim: int = 4, max_depth: float = 10.0,
                 use_pcl: bool = True, use_attention: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 pcl_warp: str = "two_pass", norm: str = "batch",
                 decoder_upsample: str = "transpose",
                 sa_lowering: str = "toeplitz", remat=False):
        super().__init__(5, in_channels, init_features, camera_dim,
                         max_depth, use_pcl, use_attention, dtype, pcl_warp,
                         norm, decoder_upsample, sa_lowering, remat)


class LightweightGeometryNetwork(_GeometryUNet):
    """The 4-level variant, attention and a PCL on every level; the
    factory caps ``init_features`` at 32. Takes and returns what
    :class:`GeometryAwareNetwork` does, H and W of at least 16, by the
    same pooling and band rules.
    """

    def __init__(self, in_channels: int = 3, init_features: int = 32,
                 camera_dim: int = 4, max_depth: float = 10.0,
                 dtype: torch.dtype = torch.bfloat16,
                 pcl_warp: str = "two_pass", norm: str = "batch",
                 decoder_upsample: str = "transpose",
                 sa_lowering: str = "toeplitz", remat=False):
        super().__init__(4, in_channels, init_features, camera_dim,
                         max_depth, True, True, dtype, pcl_warp, norm,
                         decoder_upsample, sa_lowering, remat)
