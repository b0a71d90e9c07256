"""The flagship geometry-aware depth network (port of
``cadepth_tpu.models.geometry_aware``, full variant).

Ray-direction input channels, FiLM conditioning in every conv block,
Perspective Correction Layers in the decoder and CBAM attention: five
encoder levels to a 32f bottleneck and five decoder levels back.

Only ``enc1`` reads the rays. The JAX decoder pools rays for each level
and hands them to the PCL, which ignores them, so the port does not pool
them.

``remat`` checkpoints blocks as the JAX package's ``maybe_remat`` does:
True or "full" every block, "highres" the two finest levels (``enc1``,
``enc2``, ``dec2``, ``dec1``); the backward recomputes them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cadepth_tpu_torch.geometry.intrinsics import normalize_k4
from cadepth_tpu_torch.models.attention import CBAM
from cadepth_tpu_torch.models.film import FiLMLayer
from cadepth_tpu_torch.models.layers import (Conv2d, apply_norm,
                                             checkpointed, make_norm,
                                             pad_to_match, upsample2x)
from cadepth_tpu_torch.models.pcl import PerspectiveCorrectionLayer

Intermediates = Optional[Dict[str, List[torch.Tensor]]]

# The blocks at the two finest levels ("highres" remat) and the rest.
HIGHRES_BLOCKS = ("enc1", "enc2", "dec2", "dec1")
LOWRES_BLOCKS = ("enc3", "enc4", "enc5", "bottleneck", "dec5", "dec4", "dec3")


def remat_blocks(remat) -> Tuple[str, ...]:
    """The blocks that ``remat`` (False, True, "full" or "highres")
    checkpoints."""
    if not remat:
        return ()
    if remat not in (True, "full", "highres"):
        raise ValueError(f"Unknown remat mode: {remat!r}")
    return HIGHRES_BLOCKS if remat == "highres" \
        else HIGHRES_BLOCKS + LOWRES_BLOCKS


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


class GeometryAwareNetwork(nn.Module):
    """Full 5-level geometry-aware network.

    ``forward`` takes NHWC rgb (B, H, W, 3), ray_directions (B, H, W, 3)
    and camera_intrinsics (B, 4) in pixels, and returns depth in metres,
    (B, H, W, 1) float32. H and W must be divisible by 32.
    """

    def __init__(self, in_channels: int = 3, init_features: int = 64,
                 camera_dim: int = 4, max_depth: float = 10.0,
                 use_pcl: bool = True, use_attention: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 pcl_warp: str = "two_pass", norm: str = "batch",
                 decoder_upsample: str = "transpose",
                 sa_lowering: str = "toeplitz", remat=False):
        super().__init__()
        if camera_dim != 4:
            raise ValueError(f"camera_dim must be 4 ([fx, fy, cx, cy]), "
                             f"got {camera_dim}")
        f = init_features
        self.dtype = dtype
        self.max_depth = max_depth
        enc = dict(use_attention=use_attention, dtype=dtype, norm=norm,
                   sa_lowering=sa_lowering)
        dec = dict(use_pcl=use_pcl, pcl_warp=pcl_warp,
                   upsample=decoder_upsample, **enc)
        self.enc1 = RayEnhancedConv(in_channels + 3, f, dtype, norm)
        self.enc2 = GeometryEncoderBlock(f, f * 2, **enc)
        self.enc3 = GeometryEncoderBlock(f * 2, f * 4, **enc)
        self.enc4 = GeometryEncoderBlock(f * 4, f * 8, **enc)
        self.enc5 = GeometryEncoderBlock(f * 8, f * 16, **enc)
        self.bottleneck = GeometryEncoderBlock(f * 16, f * 32, **enc)
        self.dec5 = GeometryDecoderBlock(f * 32, f * 16, **dec)
        self.dec4 = GeometryDecoderBlock(f * 16, f * 8, **dec)
        self.dec3 = GeometryDecoderBlock(f * 8, f * 4, **dec)
        self.dec2 = GeometryDecoderBlock(f * 4, f * 2, **dec)
        self.dec1 = GeometryDecoderBlock(f * 2, f, **dec)
        self.out_conv = Conv2d(f, 1, 1, dtype=torch.float32)
        self.remat = frozenset(remat_blocks(remat))

    def _block(self, name: str, *args) -> torch.Tensor:
        block = getattr(self, name)
        if name in self.remat:
            return checkpointed(block, *args)
        return block(*args)

    def forward(self, rgb: torch.Tensor, ray_directions: torch.Tensor,
                camera_intrinsics: torch.Tensor,
                intermediates: Intermediates = None) -> torch.Tensor:
        """When ``intermediates`` is a dict, each PCL appends its max
        |rotation| to ``intermediates["pcl_max_rot"]``."""
        h, w = rgb.shape[1], rgb.shape[2]
        cam = normalize_k4(camera_intrinsics.float(), width=w, height=h)
        cl = torch.channels_last
        x = rgb.permute(0, 3, 1, 2).to(self.dtype).contiguous(memory_format=cl)
        rays = ray_directions.permute(0, 3, 1, 2).contiguous(memory_format=cl)

        skip1 = self._block("enc1", x, cam, rays)
        skip2 = self._block("enc2", skip1, cam)
        skip3 = self._block("enc3", skip2, cam)
        skip4 = self._block("enc4", skip3, cam)
        skip5 = self._block("enc5", skip4, cam)
        x = self._block("bottleneck", skip5, cam)

        x = self._block("dec5", x, skip5, cam, intermediates)
        x = self._block("dec4", x, skip4, cam, intermediates)
        x = self._block("dec3", x, skip3, cam, intermediates)
        x = self._block("dec2", x, skip2, cam, intermediates)
        x = self._block("dec1", x, skip1, cam, intermediates)

        x = self.out_conv(x.float())
        return (torch.sigmoid(x) * self.max_depth).permute(0, 2, 3, 1)
