"""Building blocks (port of ``cadepth_tpu.models.layers``).

Inside the models, feature maps are NCHW tensors in ``channels_last``
memory. Parameters are float32; each layer casts its input and its
parameters to its compute dtype per call, as flax's ``dtype=`` does, so
a bf16 model keeps fp32 master weights. BatchNorm computes in float32
and casts its output to the compute dtype; in training mode it keeps
flax's running statistics, not torch's.

:func:`checkpointed` runs a block under gradient checkpointing (the JAX
package's ``nn.remat``); while a block is recomputed for the backward,
:func:`recomputing` is true, and the batch norms leave their running
statistics alone, as flax's remat does.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# flax.linen.BatchNorm defaults: epsilon 1e-5, running-average momentum
# 0.99, which is torch's momentum 0.01.
BN_EPS = 1e-5
BN_MOMENTUM = 0.01
# flax.linen.GroupNorm's default epsilon (torch's GroupNorm takes 1e-5).
GN_EPS = 1e-6

_recompute = threading.local()


def recomputing() -> bool:
    """True while a checkpointed block is recomputed for the backward."""
    return getattr(_recompute, "depth", 0) > 0


@contextlib.contextmanager
def _recompute_context():
    _recompute.depth = getattr(_recompute, "depth", 0) + 1
    try:
        yield
    finally:
        _recompute.depth -= 1


def _checkpoint_contexts():
    return contextlib.nullcontext(), _recompute_context()


def checkpointed(block: nn.Module, *args):
    """``block(*args)``, keeping only the inputs for the backward, which
    recomputes the block (``torch.utils.checkpoint``, non-reentrant) with
    :func:`recomputing` true. Outside grad mode the block just runs."""
    if not torch.is_grad_enabled():
        return block(*args)
    return checkpoint(block, *args, use_reentrant=False,
                      context_fn=_checkpoint_contexts)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` over float32 parameters."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=padding, bias=bias, dilation=dilation)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias,
                        padding=self.padding, dilation=self.dilation)


class ConvTranspose2d(nn.ConvTranspose2d):
    """2x2 stride-2 transposed conv computing in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_channels, out_channels, 2, stride=2)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), stride=2)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` over float32 parameters."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _FlaxTrainingNorm:
    """Batch norm whose training mode computes as ``flax.linen.BatchNorm``
    does; eval mode is torch's own, with the same ``state_dict`` names.

    In training: float32 statistics over every axis but the channel one
    (axis 1), the variance biased and taken as E[x^2] - E[x]^2 (flax's
    ``use_fast_variance``), and the running statistics moved as
    ``0.99 * old + 0.01 * batch``, with the biased variance. torch's own
    training mode keeps the unbiased variance in ``running_var``.
    """

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x = x.float()
        dims = [0] + list(range(2, x.dim()))
        mean = x.mean(dims)
        var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
        if not recomputing():
            with torch.no_grad():
                keep = 1.0 - BN_MOMENTUM
                self.running_mean.copy_(keep * self.running_mean
                                        + BN_MOMENTUM * mean)
                self.running_var.copy_(keep * self.running_var
                                       + BN_MOMENTUM * var)
                self.num_batches_tracked.add_(1)
        shape = [1, -1] + [1] * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + \
            self.bias.view(shape)


class BatchNorm2d(_FlaxTrainingNorm, nn.BatchNorm2d):
    """BatchNorm over NCHW maps, flax's in training."""


class BatchNorm1d(_FlaxTrainingNorm, nn.BatchNorm1d):
    """BatchNorm over (B, C) vectors, flax's in training."""


def group_count(channels: int) -> int:
    """The JAX package's groups: the largest divisor of C not above 32."""
    return next(g for g in range(min(32, channels), 0, -1)
                if channels % g == 0)


def make_norm(kind: str, channels: int) -> nn.Module:
    """The per-block normalization module (``apply_norm``'s ``kind``):
    "batch", or "group" (flax's GroupNorm: no running statistics, epsilon
    1e-6)."""
    if kind == "batch":
        return BatchNorm2d(channels)
    if kind == "group":
        return nn.GroupNorm(group_count(channels), channels, eps=GN_EPS)
    raise ValueError(f"Unknown norm kind: {kind!r}")


def apply_norm(x: torch.Tensor, norm: nn.Module,
               out_dtype: torch.dtype) -> torch.Tensor:
    """Normalize in float32, cast the output to ``out_dtype``."""
    return norm(x.float()).to(out_dtype)


class ResizeConv2d(Conv2d):
    """Nearest 2x resize, then a 3x3 conv with padding 1 and a bias."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_channels, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(F.interpolate(x, scale_factor=2,
                                             mode="nearest"))


def upsample2x(in_channels: int, features: int, mode: str,
               dtype: torch.dtype) -> nn.Module:
    """The 2x decoder upsampling module: "transpose" (ConvTranspose 2x2
    stride 2, the reference's) or "resize" (nearest 2x, then Conv 3x3)."""
    if mode == "transpose":
        return ConvTranspose2d(in_channels, features, dtype)
    if mode == "resize":
        return ResizeConv2d(in_channels, features, dtype)
    raise ValueError(f"Unknown decoder_upsample mode: {mode!r}")


def pad_to_match(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Zero-pad NCHW ``x`` spatially to the skip connection's H and W:
    left/top get diff//2, right/bottom the rest."""
    diff_h = skip.shape[2] - x.shape[2]
    diff_w = skip.shape[3] - x.shape[3]
    if diff_h > 0 or diff_w > 0:
        x = F.pad(x, (max(diff_w // 2, 0), max(diff_w - diff_w // 2, 0),
                      max(diff_h // 2, 0), max(diff_h - diff_h // 2, 0)))
    return x
