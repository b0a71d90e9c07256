"""Fused masked depth-loss statistics: wrapper of ``csrc/fused_loss.cu``
and its plain versions.

Replaces ``cadepth_tpu/ops/pallas/fused_loss.py``: ``_stats_fwd_impl``
(``_stats_kernel``) and ``_grad_impl`` (``_grad_kernel``), behind
``fused_depth_loss_stats`` and ``silog_reproj_losses``. Over the pixels
with gt > 1e-6, one pass over pred and gt gives

    [sum d, sum d^2, count, sum ||backproj(pred) - backproj(gt)||]

with d = log clip(pred) - log clip(gt) (clip to [1e-6, 1000]) and the
back-projection through a per-sample K in PIXELS, k4 = [fx, fy, cx, cy]
(the model's K4 is normalized; this one is not). The op is
differentiable in ``pred`` only. As in the JAX package it is a public
op that no module calls; the train step's losses are
``losses/depth_loss.py``'s. Its sums are over the tensors it is given:
in a data-parallel process group they are this rank's, not the global
batch's (the train step's losses all-reduce theirs).

For CUDA tensors the statistics and the gradient launch their kernels
(one launch each, and nothing else) or raise; for CPU tensors they
compute the plain versions, :func:`depth_loss_stats_plain` and
:func:`depth_loss_grad_plain`. ``launches`` and ``bwd_launches`` count
kernel launches. The statistics kernel's blocks own tiles of rows that
:func:`stats_plan` picks from the shape alone; it is a cooperative
launch, whose block 0 sums the blocks' partial rows in a fixed order
after a grid-wide barrier. The rows lie in a buffer each call takes from
PyTorch's caching allocator (no kernel), so no state is kept between
calls, streams or devices. The gradient kernel's blocks own tiles of
rows and strips of columns that :func:`grad_plan` picks from the shape
alone, each thread its pixels in one pass; it reads the cotangents
where autograd hands them in (any stride, 0 included), so the op's
backward is that one launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
from torch.autograd.function import once_differentiable

from cadepth_tpu_torch.ops import _build
from cadepth_tpu_torch.ops.two_pass_warp import raise_on

EPS = 1e-6
CLAMP_MAX = 1000.0

# Kernel launches since the counts were last set to 0.
launches = 0
bwd_launches = 0

_VP = ctypes.c_void_p
_INT = ctypes.c_int

# The statistics' launch plan: threads of a block (kThreads of
# csrc/fused_loss.cu), the rows each thread takes of a tile, and the most
# blocks (kMaxStatsBlocks: all resident at once on any H100, as a
# cooperative launch needs).
THREADS = 256
ROWS_PER_THREAD = 2
STATS_MAX_BLOCKS = 256
# The gradient's rows of a tile a thread takes (kGradRows of
# csrc/fused_loss.cu), and the threads of a warp.
GRAD_ROWS_PER_THREAD = 1
WARP = 32


class StatsPlan(NamedTuple):
    """How the statistics kernel cuts a (B, H, W) map: each thread takes
    ``quad`` neighbouring columns (``threads_per_row`` threads span a
    row, ``groups`` rows at once); a tile is ``rows`` rows of one
    sample; ``tiles`` tiles over ``blocks`` blocks, tile i to block
    i mod blocks."""

    quad: int
    threads_per_row: int
    groups: int
    rows: int
    tiles: int
    blocks: int


def stats_plan(batch: int, height: int, width: int) -> StatsPlan:
    """The statistics kernel's plan over (batch, height, width), from the
    shape alone: four columns a thread where ``width % 4 == 0``, else
    one; ``min(width / quad, THREADS)`` threads a row, the block's
    threads in ``THREADS // threads_per_row`` row groups, each taking
    ``ROWS_PER_THREAD`` rows of a tile; a block a tile, up to
    ``STATS_MAX_BLOCKS`` blocks."""
    quad = 4 if width % 4 == 0 else 1
    tpr = max(1, min(width // quad, THREADS))
    groups = THREADS // tpr
    rows = groups * ROWS_PER_THREAD
    tiles = batch * (-(-height // rows) if height else 1)
    return StatsPlan(quad, tpr, groups, rows, tiles,
                     max(1, min(tiles, STATS_MAX_BLOCKS)))


class GradPlan(NamedTuple):
    """How the gradient kernel cuts a (B, H, W) map: each thread takes
    ``quad`` neighbouring columns in ``GRAD_ROWS_PER_THREAD`` rows; a
    block's ``threads_per_row`` x ``groups`` threads span a strip of
    ``threads_per_row * quad`` columns of ``rows`` rows of one sample;
    ``strips`` strips a row and ``tiles`` tiles of rows in all, so
    ``strips * tiles`` blocks, each pixel in one of them once."""

    quad: int
    threads_per_row: int
    groups: int
    rows: int
    strips: int
    tiles: int


def grad_plan(batch: int, height: int, width: int) -> GradPlan:
    """The gradient kernel's plan over (batch, height, width), from the
    shape alone: four columns a thread where ``width % 4 == 0``, else
    one; a row's column units split into the fewest strips of at most
    ``THREADS`` threads, of equal width; the block's threads in the
    fewest row groups that make it whole warps (the most that fit in
    ``THREADS`` where none does), each taking ``GRAD_ROWS_PER_THREAD``
    rows of a tile. Small blocks of whole warps share the pixels out
    evenly over the SMs, which the kernel's arithmetic needs. Every
    thread of the grid takes at most one unit of each of its rows:
    there is no second pass."""
    quad = 4 if width % 4 == 0 else 1
    units = width // quad
    strips = max(1, -(-units // THREADS))
    tpr = max(1, -(-units // strips))
    groups = next((g for g in range(1, THREADS // tpr + 1)
                   if tpr * g % WARP == 0), THREADS // tpr)
    rows = groups * GRAD_ROWS_PER_THREAD
    return GradPlan(quad, tpr, groups, rows, strips,
                    batch * -(-height // rows))


def _check(pred: torch.Tensor, gt: torch.Tensor, k4: torch.Tensor) -> None:
    if pred.dim() != 3 or gt.shape != pred.shape:
        raise ValueError(f"pred and gt must be one (B, H, W) shape, got "
                         f"{tuple(pred.shape)} and {tuple(gt.shape)}")
    if tuple(k4.shape) != (pred.shape[0], 4):
        raise ValueError(f"k4 must be ({pred.shape[0]}, 4), got "
                         f"{tuple(k4.shape)}")
    if gt.device != pred.device or k4.device != pred.device:
        raise ValueError("pred, gt and k4 must lie on one device")


def _geometry(pred: torch.Tensor, k4: torch.Tensor):
    """(xs, ys), each broadcastable to (B, H, W): (u - cx) / (fx + eps) of
    column u, (v - cy) / (fy + eps) of row v."""
    _, h, w = pred.shape
    dev = pred.device
    fx, fy, cx, cy = (k4[:, m, None, None] for m in range(4))
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    return (u - cx) / (fx + EPS), (v - cy) / (fy + EPS)


def _log_diff(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.log(pred.clamp(EPS, CLAMP_MAX)) - \
        torch.log(gt.clamp(EPS, CLAMP_MAX))


def depth_loss_stats_plain(pred: torch.Tensor, gt: torch.Tensor,
                           k4: torch.Tensor) -> torch.Tensor:
    """(4,) f32 [sum d, sum d^2, count, sum reprojection] of f32 (B, H, W)
    maps, with the kernel's f32 formulas (sums in torch's order)."""
    maskf = (gt > EPS).to(torch.float32)
    d = _log_diff(pred, gt) * maskf
    xs, ys = _geometry(pred, k4)
    e = pred - gt
    rep = torch.sqrt((xs * e) * (xs * e) + (ys * e) * (ys * e) + e * e
                     + EPS) * maskf
    return torch.stack([d.sum(), (d * d).sum(), maskf.sum(), rep.sum()])


def depth_loss_grad_plain(pred: torch.Tensor, gt: torch.Tensor,
                          k4: torch.Tensor, coefs: torch.Tensor
                          ) -> torch.Tensor:
    """d/dpred (B, H, W) f32 of ``coefs . [sum d, sum d^2, sum
    reprojection]``, coefs (3,) f32, with the kernel's f32 formulas: the
    reprojection's derivative as geom * e / sqrt(geom * e^2 + eps),
    geom = xs^2 + ys^2 + 1, and 1 / clip(pred) strictly inside the clip
    range."""
    maskf = (gt > EPS).to(torch.float32)
    pred_c = pred.clamp(EPS, CLAMP_MAX)
    d = _log_diff(pred, gt)
    in_clamp = ((pred > EPS) & (pred < CLAMP_MAX)).to(torch.float32)
    inv_pred = in_clamp / pred_c
    xs, ys = _geometry(pred, k4)
    e = pred - gt
    geom = xs * xs + ys * ys + 1.0
    drep = geom * e / torch.sqrt(geom * e * e + EPS)
    c_d, c_d2, c_rep = coefs[0], coefs[1], coefs[2]
    return maskf * (c_d * inv_pred + c_d2 * 2.0 * d * inv_pred
                    + c_rep * drep)


def _library() -> ctypes.CDLL:
    lib = _build.library("fused_loss")
    if lib.cadepth_fused_loss_stats.argtypes is None:
        lib.cadepth_fused_loss_stats.argtypes = [_VP] * 5 + [_INT] * 5 + [_VP]
        lib.cadepth_fused_loss_stats.restype = _INT
        lib.cadepth_fused_loss_grad.argtypes = (
            [_VP] * 4 + [ctypes.c_longlong] + [_INT] * 3 + [_VP]
            + [_INT] * 7 + [_VP])
        lib.cadepth_fused_loss_grad.restype = _INT
        lib.cadepth_cuda_error_string.argtypes = [_INT]
        lib.cadepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _card_args(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"fused_depth_loss_stats runs on cuda or cpu "
                             f"tensors, got {t.device}")


def depth_loss_stats(pred: torch.Tensor, gt: torch.Tensor,
                     k4: torch.Tensor) -> torch.Tensor:
    """The four statistics of f32 (B, H, W) ``pred`` and ``gt`` and (B, 4)
    ``k4``: on the card one launch of the kernel, which writes them (its
    block 0 sums the blocks' rows in a fixed order);
    :func:`depth_loss_stats_plain` on the CPU."""
    global launches
    _check(pred, gt, k4)
    pred, gt, k4 = (t.to(torch.float32).contiguous() for t in (pred, gt, k4))
    if pred.device.type == "cpu":
        return depth_loss_stats_plain(pred, gt, k4)
    _card_args(pred, gt, k4)
    plan = stats_plan(*pred.shape)
    if plan.tiles >= 2 ** 31:
        raise ValueError(f"pred shape {tuple(pred.shape)} needs more than "
                         "2^31 tiles")
    b, h, w = pred.shape
    out = torch.empty(4, dtype=torch.float32, device=pred.device)
    # the blocks' partial rows, four doubles each: written before read
    part = torch.empty(4 * plan.blocks, dtype=torch.float64,
                       device=pred.device)
    lib = _library()
    with torch.cuda.device(pred.device):
        err = lib.cadepth_fused_loss_stats(
            pred.data_ptr(), gt.data_ptr(), k4.data_ptr(), part.data_ptr(),
            out.data_ptr(), b, h, w, plan.rows, plan.blocks,
            torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "fused_depth_loss_stats")
    launches += 1
    return out


def depth_loss_grad(pred: torch.Tensor, gt: torch.Tensor, k4: torch.Tensor,
                    coefs: torch.Tensor) -> torch.Tensor:
    """d/dpred (B, H, W) f32 given the (3,) cotangents [c_d, c_d2, c_rep]
    of sums 0, 1 and 3: the kernel on the card (it reads ``coefs`` from
    device memory), :func:`depth_loss_grad_plain` on the CPU."""
    if coefs.shape != (3,):
        raise ValueError(f"coefs must be (3,), got {tuple(coefs.shape)}")
    return _grad(pred, gt, k4, coefs, (0, 1, 2))


def _grad(pred: torch.Tensor, gt: torch.Tensor, k4: torch.Tensor,
          cot: torch.Tensor, offsets: Tuple[int, int, int]) -> torch.Tensor:
    """d/dpred given the 1-D ``cot`` whose entries ``offsets`` are the
    cotangents of sums 0, 1 and 3: on the card one launch of the kernel,
    which reads them in place (any stride: no gather, copy or host
    wait); on the CPU the plain version of those entries."""
    global bwd_launches
    _check(pred, gt, k4)
    if cot.dim() != 1 or cot.shape[0] <= max(offsets):
        raise ValueError(f"the cotangents must be 1-D with more than "
                         f"{max(offsets)} entries, got {tuple(cot.shape)}")
    if cot.device != pred.device:
        raise ValueError("the cotangents must lie on pred's device")
    pred, gt, k4 = (t.to(torch.float32).contiguous() for t in (pred, gt, k4))
    cot = cot.to(torch.float32)
    if pred.device.type == "cpu":
        return depth_loss_grad_plain(pred, gt, k4, cot[list(offsets)])
    _card_args(pred, gt, k4)
    b, h, w = pred.shape
    dpred = torch.empty_like(pred)
    if dpred.numel() == 0:
        return dpred
    plan = grad_plan(b, h, w)
    lib = _library()
    with torch.cuda.device(pred.device):
        err = lib.cadepth_fused_loss_grad(
            pred.data_ptr(), gt.data_ptr(), k4.data_ptr(), cot.data_ptr(),
            cot.stride(0), *offsets, dpred.data_ptr(), b, h, w,
            plan.threads_per_row, plan.groups, plan.rows, plan.strips,
            torch.cuda.current_stream().cuda_stream)
    raise_on(lib, err, "fused_depth_loss_stats backward")
    bwd_launches += 1
    return dpred


class FusedDepthLossStats(torch.autograd.Function):
    """The statistics with the reference's elementwise backward: one
    launch of the gradient kernel for an f32 ``pred``, which reads the
    cotangents of sums 0, 1 and 3 from ``grad`` in place (the count has
    no pred-gradient)."""

    @staticmethod
    def forward(ctx, pred, gt, k4):
        ctx.save_for_backward(pred, gt, k4)
        return depth_loss_stats(pred, gt, k4)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        pred, gt, k4 = ctx.saved_tensors
        return _grad(pred, gt, k4, grad, (0, 1, 3)).to(pred.dtype), None, None


def fused_depth_loss_stats(pred: torch.Tensor, gt: torch.Tensor,
                           k4: torch.Tensor) -> torch.Tensor:
    """(B, H, W) pred and gt, (B, 4) pixel k4 [fx, fy, cx, cy] -> (4,) f32
    [sum d, sum d^2, count, sum reprojection] over gt > 1e-6;
    differentiable in ``pred`` only, its gradient in ``pred.dtype``."""
    return FusedDepthLossStats.apply(pred, gt.detach(), k4.detach())


def silog_reproj_losses(pred: torch.Tensor, gt: torch.Tensor,
                        k4: torch.Tensor, lam: float = 0.5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(SILog, reprojection) losses from the fused statistics: what
    ``scale_invariant_loss`` and ``reprojection_loss`` of
    ``losses/depth_loss.py`` give with their default gt > eps mask, 0
    each where no pixel is valid. Accepts (B, H, W, 1) or (B, H, W)."""
    if pred.dim() == 4:
        pred, gt = pred[..., 0], gt[..., 0]
    sum_d, sum_d2, count, sum_rep = fused_depth_loss_stats(pred, gt, k4)
    n = count.clamp_min(1.0)
    silog = torch.where(count > 0, sum_d2 / n - lam * (sum_d * sum_d) / (n * n),
                        0.0)
    reproj = torch.where(count > 0, sum_rep / n, 0.0)
    return silog, reproj
