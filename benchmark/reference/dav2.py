"""Depth Anything V2 (metric) in plain PyTorch at float32: the reference
that the port's ``depth_anything_v2`` is held to.

Written from the architecture (arXiv:2406.09414; DINOv2 ViT,
arXiv:2304.07193; DPT head, arXiv:2103.13413), not from the port's
modules, and importing nothing but torch. Parameter names are the
port's (upstream's), so one ``state_dict`` loads into both. TF32 is
switched off in every forward, so the card computes in full float32.

- Encoder: rgb normalised by ImageNet's mean and std, a 14x14 stride-14
  patch conv, a cls token, the learned 37x37 position table resampled
  bicubically (scale factors ((h + 0.1) / 37, (w + 0.1) / 37), float32,
  no antialiasing; as it is at 37x37), then ``depth`` pre-norm blocks:
  ``x + ls1 * attn(LN1(x))``, ``x + ls2 * mlp(LN2(x))``, LayerNorm
  epsilon 1e-6, exact GELU. The outputs of the tapped blocks pass
  through the final LayerNorm, the cls token dropped.
- Attention is materialised: softmax(q k^T / sqrt(d)) v, computed over
  blocks of :data:`QUERY_ROWS` query rows, each block recomputed in the
  backward (``torch.utils.checkpoint``) where ``remat`` is set, so that
  a float32 score tensor of batch 8 at 1,814 tokens (1.68 GB a layer)
  is never held whole. ``remat`` also recomputes each transformer block.
- DPT head: 1x1 projections, ConvTranspose k4 s4 / k2 s2 / identity /
  Conv k3 s2, 3x3 convs to ``features`` without bias, four fusion
  blocks (``x0 + RCU1(x1)``, ``RCU2``, bilinear resize with
  ``align_corners=True``, 1x1 conv), ``output_conv1``, a bilinear resize
  to the input's size, 3x3 conv to 32, ReLU, 1x1 conv, sigmoid, times
  ``max_depth``.

Departures from upstream, as the port has them: the normalisation is
inside the model (upstream's ``NormalizeImage`` is a transform); the
training it is checked under gives every leaf one learning rate (DA-V2
gives the head 10x the encoder's) and the repository's four-term depth
loss, not DA-V2's SiLog.

``Precision("float8")`` is the control: every operand and result that
the port computes in bfloat16 (the matrix products' inputs, weights and
outputs, q, k, v and the attention's probabilities, the head's maps) is
held in float8 e4m3 with one scale a tensor, and the gradients reaching
the products' outputs are rounded the same way.

This file is kept identical in ``tests/reference_dav2.py`` and
``benchmark/reference/dav2.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

PATCH = 14
TABLE_GRID = 37
LN_EPS = 1e-6
POS_OFFSET = 0.1
QUERY_ROWS = 256
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad)


class Precision:
    """"float32" (the reference) or "float8" (the control)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.low = name == "float8"

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if not self.low:
            return x
        return x + (_fp8(x) - x).detach()

    def result(self, y: torch.Tensor) -> torch.Tensor:
        if not self.low:
            return y
        y = self.operand(y)
        return _RoundGrad.apply(y) if y.requires_grad else y


FLOAT32 = Precision("float32")


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))
        self.prec = FLOAT32

    def forward(self, x):
        p = self.prec
        return p.result(F.linear(p.operand(x), p.operand(self.weight),
                                 p.operand(self.bias)))


class Conv(nn.Module):
    """A convolution (``transposed``: kernel = stride); ``low`` False
    keeps it float32 in the control too (the depth's last 1x1)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 transposed: bool = False, low: bool = True):
        super().__init__()
        shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding = stride, padding
        self.transposed, self.low = transposed, low
        self.prec = FLOAT32

    def forward(self, x):
        p = self.prec if self.low else FLOAT32
        b = None if self.bias is None else p.operand(self.bias)
        if self.transposed:
            y = F.conv_transpose2d(p.operand(x), p.operand(self.weight), b,
                                   stride=self.stride)
        else:
            y = F.conv2d(p.operand(x), p.operand(self.weight), b,
                         stride=self.stride, padding=self.padding)
        return p.result(y)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + LN_EPS) * self.weight + \
            self.bias


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return x * self.gamma


def _attend(q, k, v, low: bool):
    p = Precision("float8" if low else "float32")
    s = p.operand(q) @ p.operand(k).transpose(-2, -1) / (q.shape[-1] ** 0.5)
    return p.result(p.operand(torch.softmax(s, dim=-1)) @ p.operand(v))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.remat = False

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self.qkv(x).view(b, n, 3, self.heads,
                                   c // self.heads).permute(2, 0, 3, 1, 4)
        low = self.qkv.prec.low
        out = []
        for s in range(0, n, QUERY_ROWS):
            rows = q[:, :, s:s + QUERY_ROWS]
            if self.remat and torch.is_grad_enabled():
                out.append(checkpoint(_attend, rows, k, v, low,
                                      use_reentrant=False))
            else:
                out.append(_attend(rows, k, v, low))
        return self.proj(torch.cat(out, 2).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = Conv(3, dim, PATCH, stride=PATCH)


class ViT(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int):
        super().__init__()
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(
            torch.empty(1, TABLE_GRID * TABLE_GRID + 1, dim))
        self.patch_embed = PatchEmbed(dim)
        self.blocks = nn.ModuleList([Block(dim, heads)
                                     for _ in range(depth)])
        self.norm = LayerNorm(dim)


def position_table(pos_embed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The table of an h x w patch grid, (1, 1 + h w, dim)."""
    if (h, w) == (TABLE_GRID, TABLE_GRID):
        return pos_embed
    grid = pos_embed[:, 1:].reshape(1, TABLE_GRID, TABLE_GRID, -1)
    patch = F.interpolate(grid.permute(0, 3, 1, 2),
                          scale_factor=((h + POS_OFFSET) / TABLE_GRID,
                                        (w + POS_OFFSET) / TABLE_GRID),
                          mode="bicubic", antialias=False)
    assert patch.shape[-2:] == (h, w), patch.shape
    return torch.cat([pos_embed[:, :1],
                      patch.permute(0, 2, 3, 1).reshape(1, h * w, -1)], 1)


class RCU(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1 = Conv(f, f, 3, padding=1)
        self.conv2 = Conv(f, f, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class Fusion(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.resConfUnit1 = RCU(f)
        self.resConfUnit2 = RCU(f)
        self.out_conv = Conv(f, f, 1)

    def forward(self, x0, x1=None, size=None):
        out = x0 if x1 is None else x0 + self.resConfUnit1(x1)
        out = self.resConfUnit2(out)
        if size is None:
            size = (2 * out.shape[2], 2 * out.shape[3])
        out = F.interpolate(out, size=tuple(size), mode="bilinear",
                            align_corners=True)
        return self.out_conv(out)


class Scratch(nn.Module):
    def __init__(self, out_channels: Sequence[int], f: int):
        super().__init__()
        for i, c in enumerate(out_channels, 1):
            setattr(self, f"layer{i}_rn", Conv(c, f, 3, padding=1,
                                               bias=False))
            setattr(self, f"refinenet{i}", Fusion(f))
        self.output_conv1 = Conv(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(Conv(f // 2, 32, 3, padding=1),
                                          nn.ReLU(),
                                          Conv(32, 1, 1, low=False),
                                          nn.Sigmoid())


class Head(nn.Module):
    def __init__(self, dim: int, f: int, out_channels: Sequence[int]):
        super().__init__()
        self.projects = nn.ModuleList([Conv(dim, c, 1) for c in out_channels])
        c = out_channels
        self.resize_layers = nn.ModuleList([
            Conv(c[0], c[0], 4, stride=4, transposed=True),
            Conv(c[1], c[1], 2, stride=2, transposed=True), nn.Identity(),
            Conv(c[3], c[3], 3, stride=2, padding=1)])
        self.scratch = Scratch(out_channels, f)


class DepthAnythingV2Ref(nn.Module):
    """(rgb (B, H, W, 3) in [0, 1], H and W multiples of 14) -> depth
    (B, H, W, 1) in metres."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, taps: Sequence[int] = (4, 11, 17, 23),
                 features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 max_depth: float = 20.0):
        super().__init__()
        self.taps = tuple(taps)
        self.max_depth = max_depth
        self.pretrained = ViT(embed_dim, depth, num_heads)
        self.depth_head = Head(embed_dim, features, out_channels)
        self.prec = FLOAT32
        self.remat = False

    def set_precision(self, prec: Precision) -> None:
        self.prec = prec
        for m in self.modules():
            if hasattr(m, "prec"):
                m.prec = prec

    def set_remat(self, remat: bool) -> None:
        self.remat = remat
        for m in self.modules():
            if isinstance(m, Attention):
                m.remat = remat

    def encode(self, rgb: torch.Tensor) -> List[torch.Tensor]:
        vit = self.pretrained
        b, height, width = rgb.shape[:3]
        h, w = height // PATCH, width // PATCH
        mean = torch.tensor(MEAN, dtype=torch.float32, device=rgb.device)
        std = torch.tensor(STD, dtype=torch.float32, device=rgb.device)
        x = ((rgb - mean) / std).permute(0, 3, 1, 2)
        t = vit.patch_embed.proj(x).flatten(2).transpose(1, 2)
        t = torch.cat([vit.cls_token.expand(b, -1, -1), t], 1) + \
            position_table(vit.pos_embed, h, w)
        out = []
        for i, block in enumerate(vit.blocks):
            if self.remat and torch.is_grad_enabled():
                t = checkpoint(block, t, use_reentrant=False)
            else:
                t = block(t)
            if i in self.taps:
                out.append(vit.norm(t)[:, 1:])
        return out

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        b, height, width = rgb.shape[:3]
        h, w = height // PATCH, width // PATCH
        head = self.depth_head
        s = head.scratch
        layers = []
        for i, t in enumerate(self.encode(rgb)):
            x = t.transpose(1, 2).reshape(b, -1, h, w)
            x = head.resize_layers[i](head.projects[i](x))
            layers.append(getattr(s, f"layer{i + 1}_rn")(x))
        l1, l2, l3, l4 = layers
        p4 = s.refinenet4(l4, size=l3.shape[2:])
        p3 = s.refinenet3(p4, l3, size=l2.shape[2:])
        p2 = s.refinenet2(p3, l2, size=l1.shape[2:])
        p1 = s.refinenet1(p2, l1)
        out = F.interpolate(s.output_conv1(p1),
                            size=(h * PATCH, w * PATCH), mode="bilinear",
                            align_corners=True)
        depth = s.output_conv2(out) * self.max_depth
        return depth.permute(0, 2, 3, 1)


def forward(model: DepthAnythingV2Ref,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The model over a feed batch (its 'rgb')."""
    return model(batch["rgb"])
