"""Training-mode batch norm: wrapper of ``csrc/batch_norm.cu`` and its
plain versions.

Replaces no TPU kernel: the JAX package's batch norm is flax's
``nn.BatchNorm``, which XLA fuses. The port's plain PyTorch version of
the same maths made a dozen float32 passes over every map each way and
kept two float32 maps of each call for the backward, half of a training
step on the card, so the training batch norm of a channels_last map runs
as two passes over the map each way: forward, the per-channel sums of x
and x^2, then y = (x - mean) * (r * w) + b; backward, the per-channel
sums of dy and dy * (x - mean), then dx. Each direction has one small
per-channel launch between its passes (the variance, the running
statistics, r; the parameter gradients and dx's coefficients). The maps
are read and written in their own dtype (bf16 or float32); every
statistic and every step of arithmetic is float32 (the sums across the
kernel's blocks float64). The backward keeps only x, in its own dtype,
and the per-channel ``stats``: mean, r, r * w and whether the variance
was clamped.

The maths is flax's (``models/layers.py``: ``_FlaxTrainingNorm``): the
variance E[x^2] - E[x]^2 clamped at 0, the running statistics moved as
``keep * old + momentum * batch`` with the biased variance (not while
``update`` is False), and under a data-parallel group ``dp`` the
moments of the global batch, ``dp.mean`` of the ranks' [E[x], E[x^2]].
Its gradient is the closed form

    dbias = sum dy, dweight = r * sum dy * (x - mean),
    dx = (w * r / N) * (N * dy - sum dy - xhat * sum dy * xhat),

xhat = (x - mean) * r, without the last term where the variance was
clamped; under ``dp`` the two sums in dx are all-reduced over the group
and N is the global count (what autograd through ``dp.mean`` gives),
while dweight and dbias stay this rank's.

For CUDA tensors :func:`batch_norm_train` launches the kernels (three
launches each way without ``dp``) or raises; for CPU tensors it computes
the plain versions, :func:`forward_plain` and :func:`backward_plain`,
the same closed form in PyTorch. The model's training ``BatchNorm2d``
(``models/layers.py``) calls it on either device, so its CPU tests run
the Function the card runs. ``launches`` and ``bwd_launches``
count the forward and backward calls that ran the kernels
(``LAUNCHES_PER_CALL`` and ``BWD_LAUNCHES_PER_CALL`` launches each).
The kernels' blocks and their sums' order come from the shape alone
(:func:`plan`), so two runs give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from cadepth_tpu_torch.ops import _build
from cadepth_tpu_torch.ops.two_pass_warp import raise_on

# Calls that ran the kernels since the counts were last set to 0.
launches = 0
bwd_launches = 0
# Kernel launches a call makes without a data-parallel group.
LAUNCHES_PER_CALL = 3
BWD_LAUNCHES_PER_CALL = 3

# The launch plan: threads of a block (kThreads of csrc/batch_norm.cu),
# the most blocks of a pass (kMaxBlocks: four a SM of an H100 SXM), and
# the rows each thread takes at least before more blocks are added.
THREADS = 256
BLOCKS = 528
ROWS_PER_THREAD = 16

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


class Plan(NamedTuple):
    """A pass over an (M rows, C channels) map: each thread takes ``vec``
    neighbouring channels; a block's ``groups`` x ``rows`` threads span
    ``groups * vec`` channels (a chunk of C) of ``rows`` rows at once;
    ``blocks`` x ``chunks`` blocks, block b taking rows b * rows, + blocks
    * rows, ...."""

    vec: int
    groups: int
    rows: int
    chunks: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def plan(m: int, c: int, aligned: bool) -> Plan:
    """The kernels' plan over ``m`` rows of ``c`` channels, from the shape
    alone: 8 channels a thread where ``c % 8 == 0`` and the maps are
    16-byte aligned (``aligned``), else 1; the channel units split into
    the fewest equal chunks of at most ``THREADS``; ``THREADS // groups``
    rows a block; a block per ``rows * ROWS_PER_THREAD`` rows, at most
    ``BLOCKS``."""
    vec = 8 if c % 8 == 0 and aligned else 1
    units = c // vec
    chunks = next(k for k in range(1, units + 1)
                  if units % k == 0 and units // k <= THREADS)
    groups = units // chunks
    rows = max(1, THREADS // groups)
    blocks = max(1, min(-(-m // (rows * ROWS_PER_THREAD)), BLOCKS))
    return Plan(vec, groups, rows, chunks, blocks)


def _view(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def forward_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  running_mean: torch.Tensor, running_var: torch.Tensor,
                  num_batches_tracked: torch.Tensor, eps: float,
                  momentum: float, update: bool, dp=None,
                  out_dtype: Optional[torch.dtype] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y in ``out_dtype``, stats (4, C) float32 [mean, r, r * w,
    clamped]) of an NCHW map, in float32 (float64 for a float64 map, the
    tests' reference), the running statistics moved in place where
    ``update``."""
    xf = x.float() if x.dtype != torch.float64 else x
    dims = [0, 2, 3]
    mean = xf.mean(dims)
    mean_sq = (xf * xf).mean(dims)
    if dp is not None:
        mean, mean_sq = dp.mean(torch.cat([mean, mean_sq])).chunk(2)
    var_raw = mean_sq - mean * mean
    var = var_raw.clamp_min(0.0)
    if update:
        keep = 1.0 - momentum
        running_mean.copy_(keep * running_mean + momentum * mean)
        running_var.copy_(keep * running_var + momentum * var)
        num_batches_tracked.add_(1)
    r = torch.rsqrt(var + eps)
    mul = r * weight
    y = (xf - _view(mean)) * _view(mul) + _view(bias)
    stats = torch.stack([mean, r, mul, (var_raw < 0).to(mean.dtype)])
    return y.to(out_dtype or x.dtype), stats


def backward_plain(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                   stats: torch.Tensor, dp=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dweight, dbias) given the forward's x and
    ``stats``, in float32 (float64 for float64 maps)."""
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, dyf = x.to(wide), dy.to(wide)
    mean, r, _, clamped = stats
    dims = [0, 2, 3]
    xc = xf - _view(mean)
    s0 = dyf.sum(dims)
    s1 = (dyf * xc).sum(dims)
    dbias, dweight = s0, r * s1
    n = x.numel() // x.shape[1]
    if dp is not None:
        s0, s1 = dp.sum(torch.cat([s0, s1])).chunk(2)
        n *= dp.world_size
    k = weight * r / n
    g1 = torch.where(clamped != 0, torch.zeros_like(s1), r * s1)
    xhat = xc * _view(r)
    dx = _view(k) * ((n * dyf - _view(s0)) - xhat * _view(g1))
    return dx.to(x.dtype), dweight, dbias


_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.library("batch_norm")
    if lib.cadepth_bn_reduce.argtypes is None:
        lib.cadepth_bn_reduce.argtypes = (
            [_INT] * 4 + [_VP] * 4 + [_LL] + [_INT] * 5 + [_VP])
        lib.cadepth_bn_fwd_finalize.argtypes = (
            [_VP, _INT, ctypes.c_double] + [_VP] * 6 + [_INT, _F, _F, _F, _VP,
                                                      _INT, _VP])
        lib.cadepth_bn_apply.argtypes = (
            [_INT] * 3 + [_VP] * 4 + [_LL] + [_INT] * 5 + [_VP])
        lib.cadepth_bn_bwd_finalize.argtypes = (
            [_VP, _INT] + [_VP] * 4 + [_F] + [_VP] * 3 + [_INT, _VP])
        lib.cadepth_bn_dx.argtypes = (
            [_INT] * 3 + [_VP] * 4 + [_F, _VP, _LL] + [_INT] * 5 + [_VP])
        for fn in (lib.cadepth_bn_reduce, lib.cadepth_bn_fwd_finalize,
                   lib.cadepth_bn_apply, lib.cadepth_bn_bwd_finalize,
                   lib.cadepth_bn_dx):
            fn.restype = _INT
        lib.cadepth_cuda_error_string.argtypes = [_INT]
        lib.cadepth_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check_map(x: torch.Tensor) -> None:
    """What the kernels take: a 4-D channels_last map of bf16 or float32
    on the card."""
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm_train runs on cuda or cpu tensors, "
                         f"got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"batch_norm_train takes (B, C, H, W) maps, got "
                         f"{x.dim()}-D {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("batch_norm_train takes channels_last maps; got "
                         f"shape {tuple(x.shape)}, strides {x.stride()}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"batch_norm_train takes bf16 or float32 maps, got "
                         f"{x.dtype}")


def _vector(t: torch.Tensor, c: int, name: str) -> int:
    if t.dtype != torch.float32 or t.shape != (c,) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({c},) float32 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t.data_ptr()


def _pass(x: torch.Tensor, *maps: torch.Tensor) -> Tuple[int, int, Plan]:
    b, c, h, w = x.shape
    m = b * h * w
    return m, c, plan(m, c, all(t.data_ptr() % 16 == 0
                                for t in (x,) + maps))


def _stream(x: torch.Tensor) -> int:
    """The raw handle of the current stream on x's card (the handle
    without a ``torch.cuda.Stream`` made for it each call)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _forward_card(x, weight, bias, running_mean, running_var,
                  num_batches_tracked, eps, momentum, update, dp, out_dtype):
    global launches
    check_map(x)
    if out_dtype not in _DTYPES:
        raise ValueError(f"batch_norm_train writes bf16 or float32, not "
                         f"{out_dtype}")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device,
                    memory_format=torch.channels_last)
    m, c, p = _pass(x, y)
    ptrs = [_vector(t, c, n) for t, n in ((weight, "weight"), (bias, "bias"),
                                          (running_mean, "running_mean"),
                                          (running_var, "running_var"))]
    if num_batches_tracked.dtype != torch.int64 or \
            num_batches_tracked.device != x.device:
        raise ValueError("num_batches_tracked must be an int64 tensor on "
                         "the map's card")
    part = torch.empty(p.blocks * 2 * c, dtype=torch.float32, device=x.device)
    stats = torch.empty(4, c, dtype=torch.float32, device=x.device)
    lib = _library()
    geometry = (m, c, p.groups, p.rows, p.chunks, p.blocks)
    keep = 1.0 - momentum
    with torch.cuda.device(x.device):
        s = _stream(x)
        dt = _DTYPES[x.dtype]
        raise_on(lib, lib.cadepth_bn_reduce(
            0, dt, dt, p.vec, x.data_ptr(), None, None, part.data_ptr(),
            *geometry, s), "batch_norm_train statistics")
        source = (part.data_ptr(), p.blocks, float(m), None)
        if dp is not None:
            moments = torch.empty(2 * c, dtype=torch.float32, device=x.device)
            raise_on(lib, lib.cadepth_bn_fwd_finalize(
                *source, moments.data_ptr(), None, None, None, None, 0, eps,
                keep, momentum, None, c, s), "batch_norm_train moments")
            moments = dp.mean(moments).contiguous()
            source = (None, 0, 0.0, moments.data_ptr())
        raise_on(lib, lib.cadepth_bn_fwd_finalize(
            *source, None, ptrs[0], ptrs[2], ptrs[3],
            num_batches_tracked.data_ptr(), int(update), eps, keep, momentum,
            stats.data_ptr(), c, s), "batch_norm_train per-channel")
        raise_on(lib, lib.cadepth_bn_apply(
            dt, _DTYPES[out_dtype], p.vec, x.data_ptr(), stats.data_ptr(),
            ptrs[1], y.data_ptr(), *geometry, s), "batch_norm_train apply")
    launches += 1
    return y, stats


def _backward_card(x, dy, weight, stats, dp):
    global bwd_launches
    if dy.dtype not in _DTYPES:
        raise ValueError(f"batch_norm_train's gradient must be bf16 or "
                         f"float32, got {dy.dtype}")
    dy = dy.contiguous(memory_format=torch.channels_last)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    m, c, p = _pass(x, dy, dx)
    n = m * (1 if dp is None else dp.world_size)
    # the blocks' partial rows, then dx's coefficients (3 * C)
    part = torch.empty((p.blocks * 2 + 3) * c, dtype=torch.float32,
                       device=x.device)
    coef = part.data_ptr() + p.blocks * 2 * c * part.element_size()
    dweight = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty(c, dtype=torch.float32, device=x.device)
    lib = _library()
    geometry = (m, c, p.groups, p.rows, p.chunks, p.blocks)
    dtx, dtd = _DTYPES[x.dtype], _DTYPES[dy.dtype]
    w = weight.data_ptr()
    with torch.cuda.device(x.device):
        s = _stream(x)
        raise_on(lib, lib.cadepth_bn_reduce(
            1, dtx, dtd, p.vec, x.data_ptr(), dy.data_ptr(), stats.data_ptr(),
            part.data_ptr(), *geometry, s), "batch_norm_train gradient sums")
        local = (part.data_ptr(), p.blocks)
        grads = (dweight.data_ptr(), dbias.data_ptr())
        if dp is None:
            raise_on(lib, lib.cadepth_bn_bwd_finalize(
                *local, None, None, stats.data_ptr(), w, float(n), *grads,
                coef, c, s), "batch_norm_train backward per-channel")
        else:
            sums = torch.empty(2 * c, dtype=torch.float32, device=x.device)
            raise_on(lib, lib.cadepth_bn_bwd_finalize(
                *local, None, sums.data_ptr(), stats.data_ptr(), w, float(n),
                *grads, None, c, s), "batch_norm_train gradient sums")
            sums = dp.sum(sums).contiguous()
            raise_on(lib, lib.cadepth_bn_bwd_finalize(
                None, 0, sums.data_ptr(), None, stats.data_ptr(), w, float(n),
                None, None, coef, c, s),
                "batch_norm_train backward per-channel")
        raise_on(lib, lib.cadepth_bn_dx(
            dtx, dtd, p.vec, x.data_ptr(), dy.data_ptr(), stats.data_ptr(),
            coef, float(n), dx.data_ptr(), *geometry, s),
            "batch_norm_train dx")
    bwd_launches += 1
    return dx, dweight, dbias


class BatchNormTrain(torch.autograd.Function):
    """The training batch norm of :func:`batch_norm_train`, its backward
    the closed form: the kernels on the card, the plain versions on the
    CPU. Saves x, the weight and the per-channel ``stats`` alone."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var,
                num_batches_tracked, eps, momentum, update, dp, out_dtype):
        if x.device.type == "cpu":
            y, stats = forward_plain(x, weight, bias, running_mean,
                                     running_var, num_batches_tracked, eps,
                                     momentum, update, dp, out_dtype)
        else:
            y, stats = _forward_card(x, weight, bias, running_mean,
                                     running_var, num_batches_tracked, eps,
                                     momentum, update, dp, out_dtype)
        ctx.save_for_backward(x, weight, stats)
        ctx.dp = dp
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dweight, dbias = backward_plain(x, dy, weight, stats, ctx.dp)
        else:
            dx, dweight, dbias = _backward_card(x, dy, weight, stats, ctx.dp)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dweight if need[1] else None,
                dbias if need[2] else None) + (None,) * 8


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor,
                     num_batches_tracked: torch.Tensor, eps: float,
                     momentum: float, update: bool = True, dp=None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax's training batch norm of the (B, C, H, W) map ``x`` (bf16 or
    float32; channels_last on the card), its output in ``out_dtype``
    (default x's): the per-channel statistics of the batch (of ``dp``'s
    global batch where given), the running statistics moved in place
    with ``momentum`` where ``update``; differentiable in x, weight and
    bias."""
    return BatchNormTrain.apply(x, weight, bias, running_mean, running_var,
                                num_batches_tracked, float(eps),
                                float(momentum), bool(update), dp,
                                out_dtype or x.dtype)
