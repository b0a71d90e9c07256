"""Building blocks (port of ``cadepth_tpu.models.layers``).

Inside the models, feature maps are NCHW tensors in ``channels_last``
memory. Parameters are float32; each layer casts its input and its
parameters to its compute dtype per call, as flax's ``dtype=`` does, so
a bf16 model keeps fp32 master weights. BatchNorm computes in float32
and casts its output to the compute dtype; in training mode it keeps
flax's running statistics, not torch's. A BatchNorm2d in training mode
runs ``ops/batch_norm.py``'s Function on the map in its own dtype: CUDA
kernels on the card, the same closed form in PyTorch on the CPU, with no
float32 map kept for the backward.

:func:`checkpointed` runs a block under gradient checkpointing (the JAX
package's ``nn.remat``); while a block is recomputed for the backward,
:func:`recomputing` is true, and the batch norms leave their running
statistics alone, as flax's remat does.

:class:`DepthUNet` is the frame every model family shares: NHWC in and
out, named blocks checkpointed as ``remat`` says (the JAX package's
``maybe_remat``: True or "full" every block, "highres" the two finest
levels, ``enc1``, ``enc2``, ``dec2`` and ``dec1``), and an f32 1x1 head
to ``sigmoid * max_depth``.

Spatial parallelism (``DepthUNet.space``, a ``parallel.SpaceGroup``):
the model takes a band of each image's rows, and a level's blocks run on
bands (inside ``parallel.spatial.banded``) while the band height stays
even, so that the 2x2 max pool into the next level stays within a band.
At the first encoder level whose band is odd, the map is gathered along
H, and that level and the ones below it run whole on every rank of the
space row. The decoder takes its band again at the first level whose
skip connection is banded: that level's block runs whole on the
gathered skip, and its output is cut to the rank's band. With H = 240
and two ranks the bands are 120, 60, 30 and 15 rows: ``enc1`` to
``enc4`` and ``dec3`` to ``dec1`` run on bands, ``enc5``, the
bottleneck, ``dec5`` and ``dec4`` whole. So a model takes images whose
height the group divides, and the band rule holds the rest: H and W
need not be divisible by 2^levels (``pad_to_match`` pads an odd
level's upsampled map).

On bands a convolution whose padding reaches across rows takes that
many halo rows from the neighbouring bands (zeros beyond the image, as
its own padding), a group norm sums its statistics over the space row,
and the batch norms keep their statistics over all ranks.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cadepth_tpu_torch.ops import batch_norm
from cadepth_tpu_torch.parallel import spatial
from cadepth_tpu_torch.utils.profiling import OFF, backward_span, span

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
def _recompute_context(space):
    _recompute.depth = getattr(_recompute, "depth", 0) + 1
    try:
        with spatial.banded(space):
            yield
    finally:
        _recompute.depth -= 1


def _checkpoint_contexts():
    # the recomputation runs on bands where the forward did (in the
    # thread that runs the backward)
    return contextlib.nullcontext(), _recompute_context(spatial.bands())


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
        space = spatial.bands()
        if space is not None and self.padding[0]:
            # the rows the padding reaches come from the neighbouring bands
            return space.conv2d(x.to(dt), self.weight.to(dt), bias,
                                self.padding, self.dilation)
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

    Under a data-parallel group (``dp``, set by :func:`sync_batch_norms`),
    E[x] and E[x^2] are those of the global batch, as flax's under JAX's
    mesh: one all-reduce of the two per-channel means, divided by the
    ranks (every rank holds as many rows). Its backward all-reduces their
    gradients, so the batch norm's gradient is exact. (torch's
    ``SyncBatchNorm`` keeps the unbiased variance and another formula.)

    :class:`BatchNorm2d` computes the same in training through
    ``ops/batch_norm.py``; this class's training forward serves
    :class:`BatchNorm1d`.
    """

    # the parallel.DataParallel whose global batch the training
    # statistics cover; None: this process's batch
    dp = None

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x = x.float()
        dims = [0] + list(range(2, x.dim()))
        mean = x.mean(dims)
        mean_sq = (x * x).mean(dims)
        if self.dp is not None:
            mean, mean_sq = self.dp.mean(torch.cat([mean, mean_sq])).chunk(2)
        var = (mean_sq - mean * mean).clamp_min(0.0)
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


def sync_batch_norms(model: nn.Module, dp) -> None:
    """Have every batch norm of ``model`` take its training statistics over
    the global batch of ``dp`` (a ``parallel.DataParallel``; None: this
    process's batch)."""
    for m in model.modules():
        if isinstance(m, _FlaxTrainingNorm):
            m.dp = dp


class BatchNorm2d(_FlaxTrainingNorm, nn.BatchNorm2d):
    """BatchNorm over NCHW maps, flax's in training. There it takes the
    map as it arrives (bf16 or float32; channels_last on the card), its
    output in ``out_dtype`` (default x's), through
    ``ops/batch_norm.batch_norm_train``: the maths of
    :class:`_FlaxTrainingNorm` in float32, its gradient the closed
    form."""

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return batch_norm.batch_norm_train(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.num_batches_tracked, self.eps, BN_MOMENTUM,
            not recomputing(), self.dp, out_dtype)


class BatchNorm1d(_FlaxTrainingNorm, nn.BatchNorm1d):
    """BatchNorm over (B, C) vectors, flax's in training."""


def group_count(channels: int) -> int:
    """The JAX package's groups: the largest divisor of C not above 32."""
    return next(g for g in range(min(32, channels), 0, -1)
                if channels % g == 0)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm``; on bands, its statistics over the whole image:
    each group's sums of x and x^2 over the space row, the variance
    E[x^2] - E[x]^2 as flax's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        space = spatial.bands()
        if space is None:
            return super().forward(x)
        b, c, h, w = x.shape
        g = x.reshape(b, self.num_groups, -1)
        sums = space.sum(torch.stack([g.sum(-1), (g * g).sum(-1)]))
        n = sums.new_tensor(float(c // self.num_groups * h * space.size * w))
        mean, mean_sq = sums / n
        var = (mean_sq - mean * mean).clamp_min(0.0)
        y = (g - mean[..., None]) * torch.rsqrt(var + self.eps)[..., None]
        return y.reshape(b, c, h, w) * self.weight.view(1, -1, 1, 1) + \
            self.bias.view(1, -1, 1, 1)


def make_norm(kind: str, channels: int) -> nn.Module:
    """The per-block normalization module (``apply_norm``'s ``kind``):
    "batch", or "group" (flax's GroupNorm: no running statistics, epsilon
    1e-6)."""
    if kind == "batch":
        return BatchNorm2d(channels)
    if kind == "group":
        return GroupNorm(group_count(channels), channels, eps=GN_EPS)
    raise ValueError(f"Unknown norm kind: {kind!r}")


def _normalize(x: torch.Tensor, norm: nn.Module,
               out_dtype: torch.dtype) -> torch.Tensor:
    if norm.training and isinstance(norm, BatchNorm2d):
        return norm(x, out_dtype)
    return norm(x.float()).to(out_dtype)


def apply_norm(x: torch.Tensor, norm: nn.Module,
               out_dtype: torch.dtype) -> torch.Tensor:
    """Normalize in float32, cast the output to ``out_dtype``.

    A :class:`BatchNorm2d` in training mode takes the map in its own
    dtype (on the card its CUDA kernels read and write it so); eval
    mode and group norm take the module on the float32 map.

    While a profiler records, the call, casts included, is span
    ``norm.fwd`` (attribute ``kernel``: 1 where the kernels ran, else 0)
    and, where a gradient flows back through it, its backward is span
    ``norm.bwd``, both with the card's time. (A block recomputed for the
    backward records its ``norm.fwd`` again, inside the backward, and no
    second ``norm.bwd``.)"""
    fwd = span("norm.fwd", device=x.device)
    if fwd is OFF:
        return _normalize(x, norm, out_dtype)
    kernel = norm.training and x.is_cuda and isinstance(norm, BatchNorm2d)
    with fwd.set(kernel=int(kernel)):
        x, mark = backward_span("norm.bwd", x,
                                OFF if recomputing() else fwd)
        return mark(_normalize(x, norm, out_dtype))


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


class DoubleConv(nn.Module):
    """Conv3x3 -> norm -> ReLU -> Conv3x3 -> norm -> ReLU."""

    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch"):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(in_channels, features, 3, padding=1, bias=False,
                            dtype=dtype)
        self.bn1 = make_norm(norm, features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False,
                            dtype=dtype)
        self.bn2 = make_norm(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(apply_norm(self.conv1(x), self.bn1, self.dtype))
        return F.relu(apply_norm(self.conv2(x), self.bn2, self.dtype))


class EncoderBlock(nn.Module):
    """MaxPool2 -> DoubleConv."""

    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch"):
        super().__init__()
        self.conv = DoubleConv(in_channels, features, dtype, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.max_pool2d(x, 2))


class DecoderBlock(nn.Module):
    """2x upsampling -> pad to the skip -> concat [skip, x] -> DoubleConv."""

    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch",
                 upsample: str = "transpose"):
        super().__init__()
        self.up = upsample2x(in_channels, features, upsample, dtype)
        self.conv = DoubleConv(2 * features, features, dtype, norm)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = pad_to_match(self.up(x), skip)
        return self.conv(torch.cat([skip, x.to(skip.dtype)], dim=1))


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


class DepthUNet(nn.Module):
    """The families' shared frame. Subclasses build their blocks and an
    ``out_conv`` (f32 1x1 conv to one channel) and run the blocks through
    :meth:`_block`, the encoder blocks through :meth:`_encode` and the
    decoder blocks through :meth:`_decode`, which follow the band rule of
    this module under ``space``."""

    # the space group whose ranks each hold a band of the image's rows
    # (None: whole images)
    space = None

    def __init__(self, dtype: torch.dtype, max_depth: float, remat,
                 camera_dim: int = 4):
        super().__init__()
        if camera_dim != 4:
            raise ValueError(f"camera_dim must be 4 ([fx, fy, cx, cy]), "
                             f"got {camera_dim}")
        self.dtype = dtype
        self.max_depth = max_depth
        self.remat = frozenset(remat_blocks(remat))

    def _block(self, name: str, *args) -> torch.Tensor:
        block = getattr(self, name)
        if name in self.remat:
            return checkpointed(block, *args)
        return block(*args)

    def _height(self, x: torch.Tensor) -> int:
        """The image's height, given the model's NHWC input."""
        return x.shape[1] * (1 if self.space is None else self.space.size)

    def _on(self, banded: bool):
        return spatial.banded(self.space if banded else None)

    def _encode(self, name: str, x: torch.Tensor, banded: bool, *args):
        """(block(x, *args), whether its output is banded) for an encoder
        block, which max-pools first: a band of odd height is gathered
        whole before it."""
        if banded and x.shape[2] % 2:
            x, banded = self.space.gather(x, 2), False
        with self._on(banded):
            return self._block(name, x, *args), banded

    def _decode(self, name: str, x: torch.Tensor, banded: bool,
                skip: torch.Tensor, skip_banded: bool, *args):
        """(block(x, skip, *args), whether its output is banded) for a
        decoder block. Where the skip is banded and ``x`` whole, the block
        runs whole on the gathered skip and its output is cut to this
        rank's band."""
        if skip_banded and not banded:
            with self._on(False):
                out = self._block(name, x, self.space.gather(skip, 2), *args)
            return self.space.band(out, 2), True
        with self._on(banded):
            return self._block(name, x, skip, *args), banded

    def _nchw(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """NHWC ``x`` as an NCHW channels_last tensor of ``dtype``."""
        return x.permute(0, 3, 1, 2).to(dtype).contiguous(
            memory_format=torch.channels_last)

    def _depth(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1) f32 depth in metres from the last decoder's map."""
        x = self.out_conv(x.float())
        return (torch.sigmoid(x) * self.max_depth).permute(0, 2, 3, 1)
