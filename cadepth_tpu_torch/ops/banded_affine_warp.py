"""The banded affine warp: wrapper of ``csrc/banded_affine_warp.cu`` and
its plain version.

Replaces ``cadepth_tpu/ops/pallas/affine_warp.py``: ``pallas_affine_warp``
(kernel body ``_warp_kernel``), a bilinear ``grid_sample`` over an affine
grid (zeros padding, ``align_corners=False``) that reads a static band
of :data:`BAND_S` source rows per output row. Where
``max_rotation_rows(theta) + 2 <= BAND_S`` it equals
``grid_sample(img, affine_grid(theta))`` (``ops/grid_sample.py``); beyond
that the rows past the band are dropped, and the port drops the same
ones. As in JAX, it is a public op that no module calls, forward only:
the PCL's ``gather`` mode goes through ``ops/grid_sample.py``.

For output row j of sample b, with the coefficients of
:func:`pixel_coeffs`:

* ``u = (ax*o + bx*j) + cx`` and ``v = (ay*o + by*j) + cy`` at column o;
* the band starts at ``ys = clip(floor(min(v(0, j), v(W-1, j))), -BAND_S,
  H)`` and holds ``s_hi = min(ceil(max(...)) - ys + 2, BAND_S)`` rows;
* ``out = sum_y sum_{x in (x0, x0+1)} fl(img[y, x] * fl(wx * wy))`` in f32
  over the band rows in order, ``wy = max(0, 1 - |v - y|)``,
  ``wx = (1 - (u - x0), u - x0)``, ``x0 = floor(u)``; rows outside
  [0, H) and columns outside [0, W-1] add nothing; cast to ``img.dtype``.

That is what the reference's one-hot matrix products reduce to: each
output lane sums one product and zeros. :func:`banded_affine_warp`
launches the kernel for a CUDA tensor (one launch per call, counted in
``launches``) or raises; for a CPU tensor it computes
:func:`banded_affine_warp_plain`. The kernel's blocks own tiles of rows,
columns and channels that :func:`affine_plan` picks from the shape alone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from cadepth_tpu_torch.ops import _build
from cadepth_tpu_torch.ops.two_pass_warp import (
    DTYPE_CODE,
    check_card_args,
    raise_on,
    vector_width,
)

BAND_S = 16  # static vertical band (rows) of the reference

# Kernel launches since the count was last set to 0.
launches = 0
LAUNCHES_PER_CALL = 1

# The launch plan: threads of a block (kThreads of csrc/warp_common.cuh);
# bytes of a tap-table entry (kTapBytes of csrc/banded_affine_warp.cu)
# and the most a block's table takes (the shared memory a block has
# without opting in); the fewest blocks a launch is planned to have where
# splitting allows it, about two for each of an H100's 132 SMs (a
# constant, not the card's SM count, so the plan is the same on every
# card); the most rows and items (pixel vectors) a block is given.
THREADS = 256
TAP_BYTES = 24
TABLE_BYTES = 48 * 1024
MIN_BLOCKS = 256
MAX_ROWS = 8
MAX_ITEMS = 16 * THREADS

_VP = ctypes.c_void_p
_INT = ctypes.c_int


def pixel_coeffs(theta: torch.Tensor, height: int, width: int
                 ) -> Tuple[torch.Tensor, ...]:
    """(ax, bx, cx, ay, by, cy), six (B,) f32 tensors: the source pixel
    position of output (row j, column o) is ``u = ax*o + bx*j + cx``,
    ``v = ay*o + by*j + cy``, with the reference's ``_pixel_coeffs``
    operations term by term (``t00*w/w``, ``((t00*(1/w - 1) + ...) * w -
    1) / 2``, the Python constants rounded to f32). The divisions by W and
    H divide by device tensors: PyTorch's CUDA division by a Python float
    multiplies by its reciprocal."""
    t = theta.to(torch.float32)
    h, w = height, width
    hf, wf = t.new_tensor(float(h)), t.new_tensor(float(w))
    kx, ky = 1 / w - 1, 1 / h - 1
    ax = t[:, 0, 0] * w / wf
    bx = t[:, 0, 1] * w / hf
    cx = ((t[:, 0, 0] * kx + t[:, 0, 1] * ky + t[:, 0, 2] + 1) * w - 1) / 2
    ay = t[:, 1, 0] * h / wf
    by = t[:, 1, 1] * h / hf
    cy = ((t[:, 1, 0] * kx + t[:, 1, 1] * ky + t[:, 1, 2] + 1) * h - 1) / 2
    return ax, bx, cx, ay, by, cy


def max_rotation_rows(theta: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """(B,) f32: the vertical span in rows of one output row's samples,
    ``|ay| * (W - 1)``. The band covers a theta iff this + 2 <=
    :data:`BAND_S`."""
    return pixel_coeffs(theta, height, width)[3].abs() * (width - 1)


def _band_rows(ay: torch.Tensor, by: torch.Tensor, cy: torch.Tensor,
               height: int, width: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(by*j, ys, s_hi) per (sample, output row): ``by * j`` (B, H) f32,
    the band's first row ``ys`` and its row count ``s_hi`` (B, H) int64.

    The float clips before the int conversion keep it in range and change
    nothing: ys is clipped to [-BAND_S, H] anyway, and past 2^24 s_hi is
    BAND_S or below 1 either way."""
    jf = torch.arange(height, dtype=torch.float32, device=ay.device)
    byj = by[:, None] * jf[None, :]
    v0 = (ay[:, None] * 0.0 + byj) + cy[:, None]
    v1 = (ay[:, None] * (width - 1) + byj) + cy[:, None]
    ys = torch.floor(torch.minimum(v0, v1)).clamp(-BAND_S, height).long()
    top = torch.ceil(torch.maximum(v0, v1)).clamp(-2.0 ** 24, 2.0 ** 24)
    s_hi = (top.long() - ys + 2).clamp_max(BAND_S)
    return byj, ys, s_hi


class AffinePlan(NamedTuple):
    """How the kernel's launch cuts a (B, H, W, C) map: ``vec`` channels
    a thread moves, blocks of ``rows`` output rows, ``cols`` columns and
    ``c_chunk`` channels, ``blocks`` of them, and the ``smem`` bytes of a
    block's tap table."""

    vec: int
    rows: int
    cols: int
    c_chunk: int
    blocks: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_of(batch: int, height: int, width: int, channels: int, vec: int,
            rows: int, cols: int, c_chunk: int) -> AffinePlan:
    """The :class:`AffinePlan` of a tiling: its block count and table
    bytes."""
    blocks = batch * _cdiv(height, rows) * _cdiv(width, cols) * \
        _cdiv(channels, c_chunk)
    return AffinePlan(vec, rows, cols, c_chunk, blocks,
                      rows * cols * TAP_BYTES)


def affine_plan(batch: int, height: int, width: int, channels: int,
                dtype: torch.dtype, aligned: bool = True) -> AffinePlan:
    """The kernel's launch plan over a (batch, height, width, channels)
    map, from the shape alone.

    A block's strip is the whole row where the table of one row fits
    :data:`TABLE_BYTES`. Its channel chunk starts at all channels and
    halves, in whole vectors (:func:`~cadepth_tpu_torch.ops.two_pass_warp.
    vector_width`), while the launch has fewer than :data:`MIN_BLOCKS`
    blocks and the halved chunk still gives each of a block's
    :data:`THREADS` threads two items of a row: the flagship's small
    decoder levels are a few rows of many channels. Then its rows double
    while the launch keeps :data:`MIN_BLOCKS` blocks, a block at most
    :data:`MAX_ROWS` rows and :data:`MAX_ITEMS` items, and the table
    :data:`TABLE_BYTES`.
    """
    vec = vector_width(channels, dtype, aligned)
    cols = min(width, TABLE_BYTES // TAP_BYTES)
    chunk = channels
    while plan_of(batch, height, width, channels, vec, 1, cols,
                  chunk).blocks < MIN_BLOCKS:
        half = max(vec, _cdiv(chunk // 2, vec) * vec)
        if half == chunk or cols * (half // vec) < 2 * THREADS:
            break
        chunk = half
    rows = 1
    while 2 * rows <= min(height, MAX_ROWS):
        more = plan_of(batch, height, width, channels, vec, 2 * rows, cols,
                       chunk)
        if more.blocks < MIN_BLOCKS or more.smem > TABLE_BYTES or \
                2 * rows * cols * _cdiv(chunk, vec) > MAX_ITEMS:
            break
        rows *= 2
    return plan_of(batch, height, width, channels, vec, rows, cols, chunk)


def check_args(img: torch.Tensor, theta: torch.Tensor) -> None:
    if img.dim() != 4:
        raise ValueError(f"img must be (B, H, W, C), got {tuple(img.shape)}")
    if tuple(theta.shape) != (img.shape[0], 2, 3):
        raise ValueError(f"theta must be ({img.shape[0]}, 2, 3), "
                         f"got {tuple(theta.shape)}")
    if not img.dtype.is_floating_point:
        raise TypeError(f"img must be a float tensor, got {img.dtype}")
    if torch.is_grad_enabled() and (img.requires_grad or theta.requires_grad):
        raise RuntimeError("banded_affine_warp is forward only (the "
                           "reference defines no gradient); call it under "
                           "torch.no_grad() or on tensors without grad")


def banded_affine_warp_plain(img: torch.Tensor,
                             theta: torch.Tensor) -> torch.Tensor:
    """The banded warp in plain PyTorch: the same positions, band, taps
    and f32 sum order as the kernel. Adds the zero-weight taps the kernel
    skips, which leaves the f32 sum unchanged for finite features."""
    check_args(img, theta)
    bsz, h, w, _ = img.shape
    dev = img.device
    ax, bx, cx, ay, by, cy = pixel_coeffs(theta, h, w)
    byj, ys, s_hi = _band_rows(ay, by, cy, h, w)
    jf = torch.arange(h, dtype=torch.float32, device=dev)
    of = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    bxj = (bx[:, None] * jf[None, :])[..., None]               # (B, H, 1)
    u = (ax[:, None, None] * of + bxj) + cx[:, None, None]      # (B, H, W)
    v = (ay[:, None, None] * of + byj[..., None]) + cy[:, None, None]
    x0 = torch.floor(u)
    wx1 = u - x0
    corners = ((x0, 1.0 - wx1), (x0 + 1.0, wx1))
    fy = torch.floor(v)
    ysf, s_hif = ys[..., None].float(), s_hi[..., None].float()
    bi = torch.arange(bsz, device=dev)[:, None, None]
    zero = u.new_zeros(())
    acc = torch.zeros(img.shape, dtype=torch.float32, device=dev)
    for dy in (0.0, 1.0):
        y = fy + dy
        s = y - ysf
        in_band = (y >= 0) & (y <= h - 1) & (s >= 0) & (s < s_hif)
        wy = torch.where(in_band,
                         torch.clamp_min(1.0 - (v - y).abs(), 0.0), zero)
        iy = y.clamp(0, h - 1).long()
        for xc, wxc in corners:
            ok = (xc >= 0) & (xc <= w - 1)
            wgt = torch.where(ok, wxc * wy, zero)
            ix = xc.clamp(0, w - 1).long()
            acc = acc + img[bi, iy, ix].float() * wgt[..., None]
    return acc.to(img.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.library("banded_affine_warp")
    if lib.cadepth_banded_affine_warp.argtypes is None:
        lib.cadepth_banded_affine_warp.argtypes = [_VP] * 3 + [_INT] * 10 + [_VP]
        lib.cadepth_banded_affine_warp.restype = _INT
        lib.cadepth_cuda_error_string.argtypes = [_INT]
        lib.cadepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


def banded_affine_warp(img: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Warp NHWC ``img`` (B, H, W, C) by affine ``theta`` (B, 2, 3):
    bilinear, zeros padding, ``align_corners=False``, summed over the band
    of :data:`BAND_S` rows per output row. Forward only.

    On the card ``img`` is a contiguous float32 or bfloat16 tensor and
    the kernel runs (one launch); a CPU tensor takes
    :func:`banded_affine_warp_plain`. Returns a new tensor of
    ``img.dtype``."""
    global launches
    check_args(img, theta)
    if img.device.type == "cpu":
        return banded_affine_warp_plain(img, theta)
    check_card_args(img, theta, "banded_affine_warp")
    if img.dtype not in DTYPE_CODE:
        raise TypeError(f"the banded_affine_warp kernel takes float32 or "
                        f"bfloat16, got {img.dtype}")
    bsz, h, w, ch = img.shape
    if max(h, w) >= 2 ** 24:
        raise ValueError(f"img shape {tuple(img.shape)}: H and W must stay "
                         "below 2^24 (f32 pixel positions)")
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    aligned = img.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    plan = affine_plan(bsz, h, w, ch, img.dtype, aligned)
    if plan.blocks >= 2 ** 31:
        raise ValueError(f"img shape {tuple(img.shape)} needs more than "
                         "2^31 blocks")
    _launch(img, theta, out, plan)
    launches += LAUNCHES_PER_CALL
    return out


def _launch(img: torch.Tensor, theta: torch.Tensor, out: torch.Tensor,
            plan: AffinePlan) -> None:
    """One launch of the kernel, img -> out, with the tiling ``plan``."""
    bsz, h, w, ch = img.shape
    theta = theta.to(torch.float32).contiguous()
    lib = _library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cadepth_banded_affine_warp(
            img.data_ptr(), out.data_ptr(), theta.data_ptr(), bsz, h, w, ch,
            DTYPE_CODE[img.dtype], plan.vec, plan.rows, plan.cols,
            plan.c_chunk, plan.smem, stream)
    raise_on(lib, err, "banded_affine_warp")
