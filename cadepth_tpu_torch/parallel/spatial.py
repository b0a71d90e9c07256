"""Spatial parallelism's collectives: one image's rows split over the
ranks of a space group (the ``space`` axis of JAX's ``make_mesh_2d``).

JAX shards the image height over its mesh's ``space`` axis and XLA's
partitioner inserts every halo exchange, gather and reduction. Here a
rank holds a band of ``h`` consecutive rows of each of its samples, rows
``rank * h .. rank * h + h - 1`` of the image, and the operations that
cross bands are written out as collectives of a :class:`SpaceGroup`, each
an autograd Function (or made of one and of slicing) whose backward is
its adjoint:

========================  ============================================
forward                   backward
========================  ============================================
sum over the group        sum of the cotangents over the group
gather of the bands       reduce-scatter: the cotangents summed over
                          the group, each rank keeping its band's
band of a whole map       zero-padding (slicing's own backward)
halo rows of neighbours   the halo rows' cotangents sent back and added
                          to the neighbours' edge rows (a gather's)
maximum over the group    the summed cotangent to the rank(s) holding
                          the maximum, split over ties as torch's amax
========================  ============================================

So each rank can back-propagate its copy of a loss that every rank holds,
divided by the ranks, and the sum of the ranks' parameter gradients is
the gradient of one process over the whole images.

Which maps are banded is a property of the model's forward, not of the
tensors: :func:`banded` sets, for the layers run inside it, the group
over whose ranks the current map's rows are split (None: every rank
holds its whole maps), and :func:`bands` reads it. The convolutions
exchange halo rows, and the reductions over H and W sum over the group,
only while it is set (``models/layers.py``, ``models/attention.py``,
``models/pcl.py``).

Transport: a gather is ``all_gather_into_tensor`` and its adjoint
``reduce_scatter_tensor``, over flat buffers, on either backend: NCCL
takes them, and so does Gloo, with CPU tensors and with CUDA ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

_state = threading.local()


def bands() -> Optional["SpaceGroup"]:
    """The group whose ranks split the current map's rows, or None."""
    return getattr(_state, "space", None)


@contextlib.contextmanager
def banded(space: Optional["SpaceGroup"]):
    """Run the enclosed layers on bands of ``space`` (None: whole maps)."""
    saved = bands()
    _state.space = space
    try:
        yield
    finally:
        _state.space = saved


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the gradients over the group,
    since each rank's result feeds that rank's own computation."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Gather(torch.autograd.Function):
    """(S, *x.shape): every rank's ``x``, stacked in rank order; the
    backward reduce-scatters the cotangent."""

    @staticmethod
    def forward(ctx, x, space):
        ctx.space = space
        return space._all_gather(x.contiguous())

    @staticmethod
    def backward(ctx, grad):
        return ctx.space._reduce_scatter(grad.contiguous()), None


class _Max(torch.autograd.Function):
    """The maximum of ``x`` over dims ``dims`` of the banded map, over the
    group; the backward gives the group's summed cotangent to the
    elements equal to it, divided by their number on all ranks (torch's
    amax splits a tie so). It keeps ``x`` itself, as amax does, not a
    mask of it."""

    @staticmethod
    def forward(ctx, x, dims, space):
        out = x.amax(dims).contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=space.group)
        shape = list(out.shape)
        for d in sorted(dims):
            shape.insert(d, 1)
        count = (x == out.view(shape)).sum(dims).to(x.dtype)
        dist.all_reduce(count, group=space.group)
        ctx.save_for_backward(x, out, count)
        ctx.shape, ctx.space = shape, space
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out, count = ctx.saved_tensors
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.space.group)
        hit = x == out.view(ctx.shape)
        return hit * (grad / count).view(ctx.shape), None, None


class _HaloConv(torch.autograd.Function):
    """``conv2d(cat([above, x, below], H), weight, bias)`` that keeps ``x``
    itself and the halo rows for the backward, not the concatenation: a
    band's copy with its halo would hold a second copy of every banded
    convolution's input until the backward. The backward concatenates
    again and runs the convolution's own backward."""

    @staticmethod
    def forward(ctx, x, above, below, weight, bias, padding, dilation):
        xc = torch.cat([above, x, below], dim=2)
        ctx.save_for_backward(x, above, below, weight)
        ctx.conv = (None if bias is None else list(bias.shape), padding,
                    dilation)
        return F.conv2d(xc, weight, bias, padding=padding, dilation=dilation)

    @staticmethod
    def backward(ctx, grad):
        x, above, below, weight = ctx.saved_tensors
        bias_sizes, padding, dilation = ctx.conv
        xc = torch.cat([above, x, below], dim=2)
        d_xc, d_w, d_b = torch.ops.aten.convolution_backward(
            grad, xc, weight, bias_sizes, [1, 1], list(padding),
            list(dilation), False, [0, 0], 1,
            [True, True, bias_sizes is not None])
        d_above, d_x, d_below = d_xc.split(
            [above.shape[2], x.shape[2], below.shape[2]], dim=2)
        return d_x, d_above, d_below, d_w, d_b, None, None


@dataclasses.dataclass(frozen=True, eq=False)
class SpaceGroup:
    """This rank's place in a space row: ``rank`` of ``size`` ranks, each
    holding a band of the same rows of the same samples. ``group`` is the
    row's process group (None: the default group)."""

    size: int
    rank: int
    group: Optional[object] = None

    # -- transport ------------------------------------------------------------

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        # flat buffers: Gloo gathers only along the first dimension
        out = x.new_empty(self.size * x.numel())
        dist.all_gather_into_tensor(out, x.reshape(-1), group=self.group)
        return out.view((self.size,) + tuple(x.shape))

    def _reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_empty(x[0].numel())
        dist.reduce_scatter_tensor(out, x.reshape(-1), group=self.group)
        return out.view(x.shape[1:])

    # -- collectives ------------------------------------------------------------

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group, differentiable."""
        return _AllReduceSum.apply(x, self.group)

    def amax(self, x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
        """The maximum of banded ``x`` over ``dims``, differentiable."""
        return _Max.apply(x, tuple(dims), self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole map: the group's bands of ``x`` concatenated along
        ``dim`` in rank order; differentiable. An NCHW channels_last map
        comes back channels_last."""
        if x.dim() == 4 and dim == 2:
            return self.gather(x.permute(0, 2, 3, 1), 1).permute(0, 3, 1, 2)
        return torch.cat(_Gather.apply(x, self).unbind(0), dim=dim)

    def band(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's band of the whole map ``x`` along ``dim``, whose
        length the group divides."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"{n} rows are not divisible by {self.size} "
                             f"bands")
        h = n // self.size
        return x.narrow(dim, self.rank * h, h)

    def row0(self, rows: int) -> int:
        """The map's index of the first of a band's ``rows`` rows."""
        return self.rank * rows

    def halo_rows(self, x: torch.Tensor, rows: int, dim: int):
        """(above, below): the ``rows`` rows of the map above and below the
        band ``x`` along ``dim``, its neighbours', zeros beyond the image's
        edges (the zero padding of a convolution); differentiable."""
        if x.dim() == 4 and dim == 2:
            above, below = self.halo_rows(x.permute(0, 2, 3, 1), rows, 1)
            return above.permute(0, 3, 1, 2), below.permute(0, 3, 1, 2)
        h = x.shape[dim]
        if rows >= h:
            # the halo reaches past the neighbours' bands
            pad = [0, 0] * (x.dim() - 1 - dim) + [rows, rows]
            whole = F.pad(self.gather(x, dim), pad)
            start = self.rank * h
            return (whole.narrow(dim, start, rows),
                    whole.narrow(dim, start + rows + h, rows))
        edges = _Gather.apply(torch.stack([x.narrow(dim, 0, rows),
                                           x.narrow(dim, h - rows, rows)]),
                              self)                  # (S, 2, ...)
        zeros = x.new_zeros(x.shape[:dim] + (rows,) + x.shape[dim + 1:])
        above = edges[self.rank - 1, 1] if self.rank > 0 else zeros
        below = edges[self.rank + 1, 0] if self.rank < self.size - 1 \
            else zeros
        return above, below

    def halo(self, x: torch.Tensor, rows: int, dim: int) -> torch.Tensor:
        """The band ``x`` with :meth:`halo_rows` above and below it along
        ``dim``; differentiable."""
        if rows == 0:
            return x
        above, below = self.halo_rows(x, rows, dim)
        return torch.cat([above, x, below], dim=dim)

    def conv2d(self, x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], padding, dilation
               ) -> torch.Tensor:
        """``F.conv2d`` of the band ``x`` (NCHW) with its halo: the rows
        its H padding reaches come from the neighbouring bands; the
        result is the band of the whole map's convolution."""
        above, below = self.halo_rows(x, padding[0], 2)
        return _HaloConv.apply(x, above.to(x.dtype), below.to(x.dtype),
                               weight, bias, (0, padding[1]), dilation)

    def mean_hw(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C) mean of a banded NCHW map over the image's H and W: a
        float32 sum over the group divided by the whole image's pixels,
        rounded to ``x.dtype`` as the mean of the whole map is."""
        n = x.new_tensor(float(x.shape[2] * self.size * x.shape[3]),
                         dtype=torch.float32)
        total = self.sum(x.sum(dim=(2, 3), dtype=torch.float32))
        return (total / n).to(x.dtype)
