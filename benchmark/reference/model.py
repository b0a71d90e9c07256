"""The geometry-aware depth network, full variant, in plain PyTorch at
float32: the reference the benchmark holds the port's forward and
gradient to.

Written from the architecture, not from the port's modules: five encoder
levels (``enc1`` over [rgb; rays], then max pool + ray-enhanced conv +
CBAM) to a 32f bottleneck, five decoder levels (2x2 transposed conv,
Perspective Correction Layer warp, concat with the skip, ray-enhanced
conv, CBAM) and a 1x1 head to ``sigmoid * max_depth``. A ray-enhanced
conv is conv3x3-BN-ReLU, FiLM on the normalized [fx, fy, cx, cy], then
conv3x3-BN-ReLU. Batch norm in training takes float32 statistics over
the batch, the variance as E[x^2] - E[x]^2 (flax's), epsilon 1e-5; in
evaluation the running statistics. FiLM's two BatchNorm1d apply only to
batches of more than one sample. The PCL predicts [sx, sy, tx, ty, rot,
shear] from [mean-pooled features; normalized K] and warps by the
two-pass function (``warp.py``).

Parameter and buffer names are the ones the port's ``state_dict`` uses,
so one set of seeded weights loads into both. Maps are NCHW; inputs and
output NHWC, as the port takes them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.precision import FLOAT32, Precision
from benchmark.reference.warp import two_pass_warp

BN_EPS = 1e-5


class Conv(nn.Module):
    """A convolution; ``low`` as :class:`Dense`'s (the head is float32)."""

    def __init__(self, cin: int, cout: int, k: int, padding: int = 0,
                 bias: bool = True, low: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.padding = padding
        self.low = low
        self.prec = FLOAT32

    def forward(self, x):
        p = self.prec if self.low else FLOAT32
        y = F.conv2d(p.operand(x), p.operand(self.weight),
                     None if self.bias is None else p.operand(self.bias),
                     padding=self.padding)
        return p.result(y)


class UpConv(nn.Module):
    """2x2 stride-2 transposed conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.empty(cout))
        self.prec = FLOAT32

    def forward(self, x):
        p = self.prec
        return p.result(F.conv_transpose2d(
            p.operand(x), p.operand(self.weight), p.operand(self.bias),
            stride=2))


class Dense(nn.Module):
    """A dense layer; ``low`` says whether the configuration computes it
    in its reduced precision (the attention gates) or in float32 (FiLM,
    the PCL's head)."""

    def __init__(self, cin: int, cout: int, low: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))
        self.low = low
        self.prec = FLOAT32

    def forward(self, x):
        if not self.low:
            return F.linear(x, self.weight, self.bias)
        p = self.prec
        return p.result(F.linear(p.operand(x), p.operand(self.weight),
                                 p.operand(self.bias)))


class Norm(nn.Module):
    """Batch norm over every axis but axis 1."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x):
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class FiLM(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.prec = FLOAT32
        self.fc1 = Dense(4, 128)
        self.fc2 = Dense(128, 256)
        self.bn1 = Norm(128)
        self.bn2 = Norm(256)
        self.fc_gamma = Dense(256, channels)
        self.fc_beta = Dense(256, channels)

    def forward(self, x, cam):
        h = self.fc1(cam)
        batched = h.shape[0] > 1
        if batched:
            h = self.bn1(h)
        h = self.fc2(F.relu(h))
        if batched:
            h = self.bn2(h)
        h = F.relu(h)
        gamma, beta = self.fc_gamma(h), self.fc_beta(h)
        p = self.prec
        return p.operand(p.operand(gamma)[:, :, None, None] * x
                         + p.operand(beta)[:, :, None, None])


class RayConv(nn.Module):
    def __init__(self, cin: int, f: int):
        super().__init__()
        self.prec = FLOAT32
        self.conv1 = Conv(cin, f, 3, padding=1, bias=False)
        self.bn1 = Norm(f)
        self.film = FiLM(f)
        self.conv2 = Conv(f, f, 3, padding=1, bias=False)
        self.bn2 = Norm(f)

    def forward(self, x, cam, rays=None):
        p = self.prec
        if rays is not None:
            x = torch.cat([x, p.operand(rays)], dim=1)
        x = F.relu(p.operand(self.bn1(self.conv1(x))))
        x = self.film(x, cam)
        return F.relu(p.operand(self.bn2(self.conv2(x))))


class ChannelGate(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        r = max(c // 16, 1)
        self.fc1 = Dense(c, r, low=True)
        self.fc2 = Dense(r, c, low=True)

    def forward(self, x):
        avg = x.mean(dim=(2, 3))
        mx = x.amax(dim=(2, 3))
        att = torch.sigmoid(self.fc2(F.relu(self.fc1(avg)))
                            + self.fc2(F.relu(self.fc1(mx))))
        return att[:, :, None, None]


class SpatialGate(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv(2, 1, 7, padding=3, bias=False)

    def forward(self, x):
        s = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv(s))


class CBAM(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.prec = FLOAT32
        self.channel_attention = ChannelGate(c)
        self.spatial_attention = SpatialGate()

    def forward(self, x):
        p = self.prec
        x = p.operand(x * self.channel_attention(x))
        return p.operand(x * self.spatial_attention(x))


class PCL(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.prec = FLOAT32
        self.loc_fc1 = Dense(c + 4, 128)
        self.loc_fc2 = Dense(128, 128)
        self.fc_transform = Dense(128, 6)

    def forward(self, x, cam, record: Optional[List] = None):
        h = F.relu(self.loc_fc1(torch.cat([x.mean(dim=(2, 3)), cam], -1)))
        prm = self.fc_transform(F.relu(self.loc_fc2(h)))
        sx, sy, tx, ty, rot, shear = prm.unbind(-1)
        cos_r, sin_r = torch.cos(rot), torch.sin(rot)
        theta = torch.stack([
            torch.stack([sx * cos_r, -sin_r + shear, tx], -1),
            torch.stack([sin_r, sy * cos_r, ty], -1)], -2)
        if record is not None:
            record.append(rot.detach().abs().max())
        out = two_pass_warp(x.permute(0, 2, 3, 1), theta)
        return self.prec.operand(out).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, cin: int, f: int):
        super().__init__()
        self.conv = RayConv(cin, f)
        self.attention = CBAM(f)

    def forward(self, x, cam):
        return self.attention(self.conv(F.max_pool2d(x, 2), cam))


class Decoder(nn.Module):
    def __init__(self, cin: int, f: int):
        super().__init__()
        self.up = UpConv(cin, f)
        self.pcl = PCL(f)
        self.conv = RayConv(2 * f, f)
        self.attention = CBAM(f)

    def forward(self, x, skip, cam, record=None):
        x = self.pcl(self.up(x), cam, record)
        dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
        if dh > 0 or dw > 0:
            x = F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.attention(self.conv(torch.cat([skip, x], dim=1), cam))


class GeometryAwareNet(nn.Module):
    """(rgb (B, H, W, 3), rays (B, H, W, 3), k4 (B, 4) in pixels) ->
    depth (B, H, W, 1) in metres."""

    def __init__(self, init_features: int = 64, max_depth: float = 10.0,
                 levels: int = 5):
        super().__init__()
        f = init_features
        self.levels = levels
        self.max_depth = max_depth
        self.enc1 = RayConv(3 + 3, f)
        for i in range(2, levels + 1):
            setattr(self, f"enc{i}", Encoder(f << (i - 2), f << (i - 1)))
        self.bottleneck = Encoder(f << (levels - 1), f << levels)
        for i in range(levels, 0, -1):
            setattr(self, f"dec{i}", Decoder(f << i, f << (i - 1)))
        self.out_conv = Conv(f, 1, 1, low=False)
        # recompute each block in the backward (exact: the reference's
        # batch norms keep no running statistics in training), so the
        # float32 reference fits the card beside what the run holds
        self.remat = False

    def set_precision(self, prec: Precision) -> None:
        for m in self.modules():
            if hasattr(m, "prec"):
                m.prec = prec

    def _block(self, block, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, rgb, rays, k4, record: Optional[List] = None):
        h, w = rgb.shape[1], rgb.shape[2]
        k4 = k4.float()
        cam = torch.stack([k4[:, 0] / w, k4[:, 1] / h,
                           (k4[:, 2] / w) * 2.0 - 1.0,
                           (k4[:, 3] / h) * 2.0 - 1.0], -1)
        x = rgb.permute(0, 3, 1, 2)
        skips = [self._block(self.enc1, x, cam, rays.permute(0, 3, 1, 2))]
        for i in range(2, self.levels + 1):
            skips.append(self._block(getattr(self, f"enc{i}"), skips[-1], cam))
        x = self._block(self.bottleneck, skips[-1], cam)
        for i in range(self.levels, 0, -1):
            if record is None:
                x = self._block(getattr(self, f"dec{i}"), x, skips[i - 1],
                                cam)
            else:
                x = getattr(self, f"dec{i}")(x, skips[i - 1], cam, record)
        d = torch.sigmoid(self.out_conv(x)) * self.max_depth
        return d.permute(0, 2, 3, 1)


def ray_grid(k: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Unit camera rays (B, H, W, 3) of K (B, 3, 3): normalize([(u - cx) /
    fx, (v - cy) / fy, 1])."""
    k = k.float()
    fx, fy = k[:, 0, 0, None, None], k[:, 1, 1, None, None]
    cx, cy = k[:, 0, 2, None, None], k[:, 1, 2, None, None]
    u = torch.arange(w, dtype=torch.float32, device=k.device)[None, None, :]
    v = torch.arange(h, dtype=torch.float32, device=k.device)[None, :, None]
    x, y = torch.broadcast_tensors((u - cx) / fx, (v - cy) / fy)
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return rays * torch.rsqrt((rays * rays).sum(-1, keepdim=True))


def forward(model: GeometryAwareNet, batch: Dict[str, torch.Tensor],
            record: Optional[List] = None) -> torch.Tensor:
    """The model over a feed batch ('rgb', 'intrinsics', 'k4'), rays
    derived from K."""
    h, w = batch["rgb"].shape[1], batch["rgb"].shape[2]
    return model(batch["rgb"], ray_grid(batch["intrinsics"], h, w),
                 batch["k4"], record)
