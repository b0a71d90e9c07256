"""CBAM and the camera-aware attention modules (port of
``cadepth_tpu.models.attention``), NCHW.

The JAX package has three TPU lowerings of the spatial gate's 7x7
conv from 2 channels to 1 (``sa_lowering``: conv, stencil, toeplitz).
They compute one convolution over one ``conv/kernel`` parameter, so on
the GPU all three are the one ``Conv2d`` below.

On bands (spatial parallelism, ``parallel/spatial.py``) the channel
gate's mean and maximum over H and W are the whole image's, over the
space row; the gates' convolutions take their halo rows in ``Conv2d``
(3 for the 7x7, 1 for the edge 3x3, 6 for the dilated 7x7), and the
reductions over channels are per pixel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cadepth_tpu_torch.models.layers import Conv2d, Linear
from cadepth_tpu_torch.parallel import spatial

SA_LOWERINGS = ("conv", "stencil", "toeplitz")


class ChannelAttention(nn.Module):
    """sigmoid(MLP(avgpool) + MLP(maxpool)) channel gate, in ``dtype``."""

    def __init__(self, channels: int, reduction_ratio: int = 16,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        reduced = max(channels // reduction_ratio, 1)
        self.fc1 = Linear(channels, reduced, dtype)
        self.fc2 = Linear(reduced, channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        space = spatial.bands()
        if space is None:
            avg = x.mean(dim=(2, 3))
            mx = x.amax(dim=(2, 3))
        else:
            avg = space.mean_hw(x)
            mx = space.amax(x, (2, 3))
        att = torch.sigmoid(self.fc2(F.relu(self.fc1(avg)))
                            + self.fc2(F.relu(self.fc1(mx))))
        return att[:, :, None, None]  # (B, C, 1, 1)


class SpatialGateConv(Conv2d):
    """KxK conv over the 2-channel [avg; max] map, no bias."""

    def __init__(self, kernel_size: int = 7, lowering: str = "toeplitz",
                 dtype: torch.dtype = torch.bfloat16):
        if kernel_size % 2 != 1:
            raise ValueError(f"SpatialGateConv requires an odd kernel_size "
                             f"(got {kernel_size})")
        if lowering not in SA_LOWERINGS:
            raise ValueError(f"spatial-attention lowering '{lowering}' not "
                             f"in {SA_LOWERINGS}")
        super().__init__(2, 1, kernel_size, padding=kernel_size // 2,
                         bias=False, dtype=dtype)


class SpatialAttention(nn.Module):
    """sigmoid(conv7x7([mean; max] over C)) spatial gate."""

    def __init__(self, kernel_size: int = 7,
                 dtype: torch.dtype = torch.bfloat16,
                 lowering: str = "toeplitz"):
        super().__init__()
        self.conv = SpatialGateConv(kernel_size, lowering, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=1, keepdim=True)
        mx = x.amax(dim=1, keepdim=True)
        return torch.sigmoid(self.conv(torch.cat([avg, mx], dim=1)))


class CBAM(nn.Module):
    """Channel then spatial attention in sequence."""

    def __init__(self, channels: int, reduction_ratio: int = 16,
                 spatial_kernel: int = 7,
                 dtype: torch.dtype = torch.bfloat16,
                 sa_lowering: str = "toeplitz"):
        super().__init__()
        self.channel_attention = ChannelAttention(channels, reduction_ratio,
                                                  dtype)
        self.spatial_attention = SpatialAttention(spatial_kernel, dtype,
                                                  sa_lowering)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * self.channel_attention(x)
        return x * self.spatial_attention(x)


class DepthSpatialAttention(nn.Module):
    """sigmoid(1x1 conv([spatial gate; sigmoid(edge 3x3 conv);
    sigmoid(dilation-2 context KxK conv)])): the edge, context and base
    attention fusion, all convs without bias."""

    def __init__(self, channels: int, kernel_size: int = 7,
                 dtype: torch.dtype = torch.bfloat16,
                 sa_lowering: str = "toeplitz"):
        super().__init__()
        self.base_attention = SpatialAttention(kernel_size, dtype, sa_lowering)
        self.edge_conv = Conv2d(channels, 1, 3, padding=1, bias=False,
                                dtype=dtype)
        # dilation 2 with "same" padding
        self.context_conv = Conv2d(channels, 1, kernel_size,
                                   padding=kernel_size // 2 * 2, bias=False,
                                   dtype=dtype, dilation=2)
        self.fusion_conv = Conv2d(3, 1, 1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        base = self.base_attention(x)
        edge = torch.sigmoid(self.edge_conv(x))
        context = torch.sigmoid(self.context_conv(x))
        fused = torch.cat([base, edge, context], dim=1)
        return torch.sigmoid(self.fusion_conv(fused))  # (B, 1, H, W)


class CameraAwareSpatialAttention(nn.Module):
    """Spatial attention conditioned on the intrinsics: a KxK conv of the
    [mean; max] channel map and a ReLU camera embedding broadcast over
    (H, W), fused by a 1x1 conv, then sigmoid."""

    def __init__(self, channels: int, camera_dim: int = 4,
                 kernel_size: int = 7, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.spatial_conv = Conv2d(2, channels, kernel_size,
                                   padding=kernel_size // 2, bias=False,
                                   dtype=dtype)
        self.camera_fc = Linear(camera_dim, channels, dtype)
        self.fusion_conv = Conv2d(2 * channels, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor,
                camera_params: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=1, keepdim=True)
        mx = x.amax(dim=1, keepdim=True)
        spatial = self.spatial_conv(torch.cat([avg, mx], dim=1))
        cam = F.relu(self.camera_fc(camera_params.to(self.dtype)))
        cam = cam[:, :, None, None].expand_as(spatial)
        fused = torch.cat([spatial, cam], dim=1)
        return torch.sigmoid(self.fusion_conv(fused))  # (B, 1, H, W)
