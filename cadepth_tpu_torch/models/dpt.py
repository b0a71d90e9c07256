"""The DPT head and Depth Anything V2, metric variant (no JAX counterpart).

Written from Depth Anything V2 (arXiv:2406.09414), its
``metric_depth/depth_anything_v2/dpt.py``, with the DPT decoder of
arXiv:2103.13413: the ViT's four tapped token maps, each reshaped to
(dim, h, w), projected by a 1x1 conv (``projects``) to ``out_channels``
and resized (``resize_layers``: ConvTranspose k4 s4, ConvTranspose k2
s2, identity, Conv k3 s2 p1) to four scales, each taken to ``features``
by a 3x3 conv without bias (``scratch.layerN_rn``), then fused from the
coarsest up by four ``FeatureFusionBlock``s (``scratch.refinenetN``):
``out = x0 + RCU1(x1)``, ``RCU2(out)``, a bilinear resize with
``align_corners=True`` to the next finer map's size (x2 for the finest),
a 1x1 ``out_conv``; an RCU is ``x + conv3x3(relu(conv3x3(relu(x))))``.
``refinenet4`` takes one input, so its ``resConfUnit1`` is built and
never used, as upstream's: its parameters get no gradient (the train
step gives them zeros, which AdamW's decay still moves). The output:
``output_conv1`` (3x3, features -> features / 2), a bilinear resize
(``align_corners=True``) to the input's size, ``output_conv2`` (3x3 to
32, ReLU, 1x1 to 1, sigmoid), times ``max_depth``. No batch norm
anywhere. Module names are upstream's (``depth_head.scratch.refinenet1.
resConfUnit2.conv1``, ``pretrained.blocks.N...``).

``DepthAnythingV2`` takes NHWC rgb in [0, 1] (B, H, W, 3), H and W
multiples of 14, normalises it by ImageNet's mean and standard deviation
(upstream's ``NormalizeImage``, done here so the feed stays the other
families'), and returns depth in metres (B, H, W, 1), float32. It reads
no intrinsics: ``model_inputs`` hands it ``(rgb,)``.

Precision: the head's convolutions and resizes compute in ``dtype``
(bf16 on the card) on channels_last maps over float32 parameters; the
last 1x1 conv and the sigmoid are float32, as the other families' heads.

While a profiler records, the head's forward is span ``dpt.head`` and
its backward ``dpt.head.bwd`` (from the depth's gradient down to its
four inputs'), with the card's time; the encoder's spans are in
``dinov2.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cadepth_tpu_torch.models.dinov2 import PATCH, DinoVisionTransformer
from cadepth_tpu_torch.utils.profiling import backward_span, span

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def check_grid(height: int, width: int) -> None:
    """Raise unless the image's height and width are multiples of 14."""
    if height % PATCH or width % PATCH:
        raise ValueError(
            f"depth_anything_v2 takes images whose height and width are "
            f"multiples of {PATCH}; got {height}x{width}")


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` over float32 parameters."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt),
                        self.stride, self.padding)


class UpConv(nn.ConvTranspose2d):
    """ConvTranspose2d with kernel = stride = ``k``, in ``dtype``."""

    def __init__(self, channels: int, k: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(channels, channels, k, stride=k)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), stride=self.stride)


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(features, features, 3, padding=1, dtype=dtype)
        self.conv2 = Conv(features, features, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features, dtype)
        self.resConfUnit2 = ResidualConvUnit(features, dtype)
        self.out_conv = Conv(features, features, 1, dtype=dtype)

    def forward(self, *xs: torch.Tensor, size=None) -> torch.Tensor:
        out = xs[0]
        if len(xs) == 2:
            out = out + self.resConfUnit1(xs[1])
        out = self.resConfUnit2(out)
        if size is None:
            size = (2 * out.shape[2], 2 * out.shape[3])
        return self.out_conv(_resize(out, size))


class _Scratch(nn.Module):
    """Upstream's ``scratch``: the 3x3 convs to ``features``, the fusion
    blocks and the output convs."""

    def __init__(self, out_channels: Sequence[int], features: int,
                 dtype: torch.dtype):
        super().__init__()
        for i, c in enumerate(out_channels, 1):
            setattr(self, f"layer{i}_rn",
                    Conv(c, features, 3, padding=1, bias=False, dtype=dtype))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features,
                                                              dtype))
        half = features // 2
        self.output_conv1 = Conv(features, half, 3, padding=1, dtype=dtype)
        self.output_conv2 = nn.Sequential(
            Conv(half, 32, 3, padding=1, dtype=dtype), nn.ReLU(),
            Conv(32, 1, 1, dtype=torch.float32), nn.Sigmoid())


class DPTHead(nn.Module):
    """Four token maps (B, h * w, dim) -> (B, 1, 14 h, 14 w) in (0, 1)."""

    def __init__(self, in_channels: int = 1024, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.projects = nn.ModuleList([Conv(in_channels, c, 1, dtype=dtype)
                                       for c in out_channels])
        self.resize_layers = nn.ModuleList([
            UpConv(out_channels[0], 4, dtype),
            UpConv(out_channels[1], 2, dtype),
            nn.Identity(),
            Conv(out_channels[3], out_channels[3], 3, stride=2, padding=1,
                 dtype=dtype)])
        self.scratch = _Scratch(out_channels, features, dtype)
        self.dtype = dtype

    def forward(self, tokens: Sequence[torch.Tensor], h: int,
                w: int) -> torch.Tensor:
        s = self.scratch
        layers = []
        for i, t in enumerate(tokens):
            # (B, h * w, C) tokens as an NCHW view in channels_last memory
            x = t.to(self.dtype).reshape(t.shape[0], h, w, t.shape[2])
            x = self.resize_layers[i](self.projects[i](x.permute(0, 3, 1, 2)))
            layers.append(getattr(s, f"layer{i + 1}_rn")(x))
        l1, l2, l3, l4 = layers
        p4 = s.refinenet4(l4, size=l3.shape[2:])
        p3 = s.refinenet3(p4, l3, size=l2.shape[2:])
        p2 = s.refinenet2(p3, l2, size=l1.shape[2:])
        p1 = s.refinenet1(p2, l1)
        out = _resize(s.output_conv1(p1), (h * PATCH, w * PATCH))
        return s.output_conv2(out)


class DepthAnythingV2(nn.Module):
    """Depth Anything V2 (metric): ``pretrained`` the ViT, ``depth_head``
    the DPT head, depth = head * ``max_depth``. ``taps`` are the 0-based
    blocks whose outputs the head reads."""

    # spatial parallelism is not supported (``parallel/spatial.py``)
    space = None

    def __init__(self, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, taps: Sequence[int] = (4, 11, 17, 23),
                 features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 max_depth: float = 20.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if len(taps) != 4:
            raise ValueError(f"the DPT head reads four blocks, got {taps}")
        self.taps = tuple(taps)
        self.max_depth = max_depth
        self.dtype = dtype
        self.pretrained = DinoVisionTransformer(embed_dim, depth, num_heads,
                                                dtype=dtype)
        self.depth_head = DPTHead(embed_dim, features, out_channels, dtype)
        self._norm_consts: Dict[torch.device, tuple] = {}

    def _normalized(self, rgb: torch.Tensor) -> torch.Tensor:
        """(rgb - mean) / std in float32, NCHW channels_last."""
        consts = self._norm_consts.get(rgb.device)
        if consts is None:
            consts = self._norm_consts[rgb.device] = tuple(
                torch.tensor(v, dtype=torch.float32, device=rgb.device)
                for v in (IMAGENET_MEAN, IMAGENET_STD))
        mean, std = consts
        return ((rgb.float() - mean) / std).permute(0, 3, 1, 2)

    def forward(self, rgb: torch.Tensor,
                intermediates: Optional[Dict[str, List]] = None
                ) -> torch.Tensor:
        """``intermediates`` is accepted for the other families' call and
        left empty (there is no PCL)."""
        if self.space is not None:
            raise NotImplementedError(
                "depth_anything_v2 does not train on spatial bands")
        height, width = rgb.shape[1:3]
        check_grid(height, width)
        h, w = height // PATCH, width // PATCH
        outs = self.pretrained.get_intermediate_layers(
            self._normalized(rgb), self.taps)
        with span("dpt.head", device=rgb.device) as head:
            outs, mark = backward_span("dpt.head.bwd", outs, head)
            depth = mark(self.depth_head(outs, h, w))
        return (depth * self.max_depth).permute(0, 2, 3, 1)
