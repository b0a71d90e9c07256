"""The two-pass affine warp on the card: wrapper of ``csrc/two_pass_warp.cu``.

Replaces ``cadepth_tpu/ops/pallas/two_pass_warp.py``: the forward
(``_pass_v_kernel`` and ``_pass_h_kernel``, and the XLA form of
``cadepth_tpu/ops/affine_warp.py: two_pass_affine_warp``) and the
backward of ``pallas_two_pass_warp_trainable`` (``_trainable_bwd``:
``_bwd_h_kernel``, ``_bwd_v_kernel`` and the chain to d_theta).

:func:`two_pass_warp` is differentiable in ``img`` and ``theta`` while
grad mode is on and either requires grad: it goes through
:class:`TwoPassWarp`, whose forward also stores V (pass V's result) for
the backward. Otherwise, as under ``torch.no_grad`` or
``torch.inference_mode`` while serving, it launches the forward alone,
which keeps V in shared memory and writes none; that forward is the
registered op ``cadepth::two_pass_warp_fwd`` (:func:`two_pass_warp_fwd`),
so ``torch.export`` traces it as one node through its fake (shape-only)
version and an exported program calls the kernel again when it runs.

For a CUDA tensor the forward launches its kernel (one launch) and the
backward its three (the transposed passes, then the sum of their theta
partials and the chain to d_theta on the card), or raise; for a CPU
tensor they compute the plain versions, :func:`~cadepth_tpu_torch.ops.
affine_warp.two_pass_affine_warp_plain_fwd` and
``two_pass_affine_warp_plain_bwd``. ``launches`` and ``bwd_launches``
count kernel launches, so a run can show that its warps went through the
kernels; ``v_stores`` counts the forward launches that also stored V;
``grad_copies`` counts the backward calls whose incoming gradient was not
contiguous NHWC and was copied before the launch.

A window of output rows (``row0``, ``rows``; spatial parallelism,
``models/pcl.py``): the warp of the whole input, but only its output rows
``row0 .. row0 + rows - 1``. The forward returns (B, rows, W, C), those
rows of the whole warp bit for bit; the backward takes their cotangent
and returns the whole input's d_img and this window's part of d_theta,
so the windows of a partition of H sum to the whole backward. The
default window is the whole map. ``window_launches`` and
``window_bwd_launches`` count the launches whose window is not the whole
map (they count in ``launches`` and ``bwd_launches`` too).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from cadepth_tpu_torch.ops import _build
from cadepth_tpu_torch.ops.affine_warp import (
    check_warp_args,
    two_pass_affine_warp_plain_bwd,
    two_pass_affine_warp_plain_fwd,
)

# Kernel launches since the counts were last set to 0.
launches = 0
bwd_launches = 0
LAUNCHES_PER_CALL = 1
BWD_LAUNCHES_PER_CALL = 3
# Forward launches that also stored V (training; serving stores none).
v_stores = 0
# Backward calls that copied a non-contiguous incoming gradient.
grad_copies = 0
# Launches over a window of the output rows that is not the whole map.
window_launches = 0
window_bwd_launches = 0

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
# Shared memory one block may use on the card (227 KB), and the most a
# block's row chunk takes: the 48 KB a kernel gets without asking
# (csrc/two_pass_warp.cu says why this size).
SMEM_MAX = 232448
SMEM_TARGET = 48 * 1024
_VP = ctypes.c_void_p
_INT = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = _build.library("two_pass_warp")
    if lib.cadepth_two_pass_warp_fwd.argtypes is None:
        lib.cadepth_two_pass_warp_fwd.argtypes = \
            [_VP] * 4 + [_INT] * 12 + [_VP]
        lib.cadepth_two_pass_warp_fwd.restype = _INT
        lib.cadepth_two_pass_warp_bwd.argtypes = \
            [_VP] * 8 + [_INT] * 12 + [_VP]
        lib.cadepth_two_pass_warp_bwd.restype = _INT
        lib.cadepth_cuda_error_string.argtypes = [_INT]
        lib.cadepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


def vector_width(channels: int, dtype: torch.dtype,
                 aligned: bool = True) -> int:
    """Channels a kernel thread moves at once: one 16-byte vector (4 f32
    or 8 bf16) where ``channels`` is a multiple of it and the buffers are
    16-byte aligned, else 1."""
    per = 16 // ITEMSIZE[dtype]
    return per if aligned and channels % per == 0 else 1


def fwd_plan(width: int, channels: int, dtype: torch.dtype,
             aligned: bool = True) -> Tuple[int, int]:
    """(c_chunk, smem_bytes): the channels one block of the forward (and
    of the transposed pass H) holds for a whole row of ``width`` pixels
    in shared memory, and the bytes that takes.

    The chunk halves, in whole vectors (:func:`vector_width`), from all
    ``channels`` until the row's chunk fits :data:`SMEM_TARGET`; a row
    whose single vector per pixel exceeds :data:`SMEM_MAX` raises. The
    plan depends on the shape alone, so the backward's block partials,
    and d_theta's bits, are the same on every card.
    """
    size = ITEMSIZE[dtype]
    vec = vector_width(channels, dtype, aligned)
    least = width * vec * size
    if least > SMEM_MAX:
        raise ValueError(
            f"two_pass_warp keeps a row of {width} pixels in shared memory; "
            f"one vector of {vec} {str(dtype).split('.')[1]} channels per "
            f"pixel takes {least} bytes, over the {SMEM_MAX} bytes a block "
            "may use on the card")

    chunk = channels
    while width * chunk * size > SMEM_TARGET and chunk > vec:
        chunk = max(vec, -(-(chunk // 2) // vec) * vec)
    return chunk, width * chunk * size


def _plan(img: torch.Tensor, *others: torch.Tensor) -> Tuple[int, int, int]:
    """(vec, c_chunk, smem_bytes) of a launch over ``img`` and the other
    buffers of its shape and dtype, checked against the kernel's int32
    block count."""
    bsz, h, w, ch = img.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (img,) + others)
    vec = vector_width(ch, img.dtype, aligned)
    c_chunk, smem = fwd_plan(w, ch, img.dtype, aligned)
    if c_chunk and bsz * h * -(-ch // c_chunk) >= 2 ** 31:
        raise ValueError(f"img shape {tuple(img.shape)} needs more than "
                         "2^31 blocks")
    return vec, c_chunk, smem


def check_card_args(img: torch.Tensor, theta: torch.Tensor,
                    name: str = "two_pass_warp") -> None:
    """What a warp kernel takes: a contiguous NHWC ``img`` on the card,
    ``theta`` on the same card, row counts that fit the kernel's int32."""
    if img.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, "
                         f"got {img.device}")
    if theta.device != img.device:
        raise ValueError(f"theta is on {theta.device}, img on {img.device}")
    if not img.is_contiguous():
        raise ValueError("img must be a contiguous NHWC tensor (B, H, W, C); "
                         f"got strides {img.stride()}")
    bsz, h, w, ch = img.shape
    if bsz * h >= 2 ** 31 or w * ch >= 2 ** 31:
        raise ValueError(f"img shape {tuple(img.shape)} exceeds the kernel's "
                         "int32 row counts")


def raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a library's launch returned a CUDA error."""
    if err != 0:
        msg = lib.cadepth_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def window_of(img: torch.Tensor, row0: int, rows: Optional[int]
              ) -> Tuple[int, int]:
    """(row0, rows) of a window of ``img``'s output rows, checked; rows
    None: to the last row."""
    h = img.shape[1]
    rows = h - row0 if rows is None or rows < 0 else rows
    if not (0 <= row0 and 0 <= rows and row0 + rows <= h):
        raise ValueError(f"window of rows {row0} .. {row0 + rows - 1} is "
                         f"outside the map's {h} rows")
    return row0, rows


def _forward(img: torch.Tensor, theta: torch.Tensor, padding_mode: str,
             align_corners: bool, keep_v: bool, row0: int = 0,
             rows: Optional[int] = None):
    """(out, V) of the window's rows: the plain version on the CPU (V
    always), the kernel on the card (V only where ``keep_v``, else
    None)."""
    global launches, v_stores, window_launches
    row0, rows = window_of(img, row0, rows)
    if img.device.type == "cpu":
        return two_pass_affine_warp_plain_fwd(img, theta, padding_mode,
                                              align_corners, row0, rows)
    check_card_args(img, theta)
    bsz, h, w, ch = img.shape
    theta = theta.to(torch.float32).contiguous()
    out = img.new_empty(bsz, rows, w, ch)
    v = torch.empty_like(out) if keep_v else None
    plan = _plan(img, out, *([v] if keep_v else []))
    lib = _library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cadepth_two_pass_warp_fwd(
            img.data_ptr(), v.data_ptr() if keep_v else None, out.data_ptr(),
            theta.data_ptr(), bsz, h, row0, rows, w, ch,
            DTYPE_CODE[img.dtype], int(padding_mode == "border"),
            int(align_corners), *plan, stream)
    raise_on(lib, err, "two_pass_warp forward")
    launches += LAUNCHES_PER_CALL
    v_stores += int(keep_v)
    window_launches += int(rows != h) * LAUNCHES_PER_CALL
    return out, v


def two_pass_warp_bwd(img: torch.Tensor, v: torch.Tensor, theta: torch.Tensor,
                      grad_out: torch.Tensor, padding_mode: str = "zeros",
                      align_corners: bool = False, row0: int = 0,
                      rows: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_img, d_theta) of the warp's window of output rows ``row0 ..
    row0 + rows - 1`` (default: the whole map), given the forward's
    ``img``, its V of the window and ``theta``, and the contiguous
    cotangent ``grad_out`` of the window's output.

    On the card: the two transposed passes and the theta kernel, which
    sums their per-block partials and chains them to d_theta; the host
    allocates and launches, nothing else. On the CPU:
    :func:`two_pass_affine_warp_plain_bwd`.
    """
    global bwd_launches, window_bwd_launches
    check_warp_args(img, theta, padding_mode)
    row0, rows = window_of(img, row0, rows)
    if img.device.type == "cpu":
        return two_pass_affine_warp_plain_bwd(img, v, theta, grad_out,
                                              padding_mode, align_corners,
                                              row0, rows)
    check_card_args(img, theta)
    bsz, h, w, ch = img.shape
    want = (bsz, rows, w, ch)
    for name, t in (("v", v), ("grad_out", grad_out)):
        if tuple(t.shape) != want or t.dtype != img.dtype or \
                t.device != img.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {img.dtype} "
                             f"tensor of shape {want}")
    th = theta.to(torch.float32).contiguous()
    d_v = torch.empty_like(v)
    d_img = torch.empty_like(img)
    plan = _plan(img, v, grad_out, d_v, d_img)
    blocks = bsz * (rows + h) * (-(-ch // plan[1]) if plan[1] else 0)
    part = torch.empty(blocks * 3, dtype=torch.float32, device=img.device)
    d_theta = torch.empty(bsz, 2, 3, dtype=torch.float32, device=img.device)
    lib = _library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cadepth_two_pass_warp_bwd(
            grad_out.data_ptr(), v.data_ptr(), img.data_ptr(), th.data_ptr(),
            d_v.data_ptr(), d_img.data_ptr(), part.data_ptr(),
            d_theta.data_ptr(), bsz, h, row0, rows, w, ch,
            DTYPE_CODE[img.dtype], int(padding_mode == "border"),
            int(align_corners), *plan, stream)
    raise_on(lib, err, "two_pass_warp backward")
    bwd_launches += BWD_LAUNCHES_PER_CALL
    window_bwd_launches += int(rows != h) * BWD_LAUNCHES_PER_CALL
    return d_img, d_theta


class TwoPassWarp(torch.autograd.Function):
    """The warp with the backward of ``_trainable_bwd``, over the window
    of output rows ``row0 .. row0 + rows - 1`` (rows None: to the last)."""

    @staticmethod
    def forward(ctx, img, theta, padding_mode, align_corners, row0=0,
                rows=None):
        out, v = _forward(img, theta, padding_mode, align_corners,
                          keep_v=True, row0=row0, rows=rows)
        ctx.save_for_backward(img, v, theta)
        ctx.padding_mode = padding_mode
        ctx.align_corners = align_corners
        ctx.window = (row0, rows)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        global grad_copies
        img, v, theta = ctx.saved_tensors
        # the gradient arrives through the PCL's permute back to NCHW; the
        # kernel reads contiguous NHWC only, so a strided one is copied
        if not grad_out.is_contiguous():
            grad_copies += 1
        grad_out = grad_out.to(img.dtype).contiguous()
        d_img, d_theta = two_pass_warp_bwd(img, v, theta, grad_out,
                                           ctx.padding_mode,
                                           ctx.align_corners, *ctx.window)
        return d_img, d_theta.to(theta.dtype), None, None, None, None


@torch.library.custom_op("cadepth::two_pass_warp_fwd", mutates_args=())
def two_pass_warp_fwd(img: torch.Tensor, theta: torch.Tensor,
                      padding_mode: str, align_corners: bool, row0: int = 0,
                      rows: int = -1) -> torch.Tensor:
    """The warp's forward without V, over the window of output rows
    ``row0 .. row0 + rows - 1`` (rows -1: to the last): the kernel for a
    CUDA tensor, the plain version for a CPU one."""
    return _forward(img, theta, padding_mode, align_corners,
                    keep_v=False, row0=row0, rows=rows)[0]


@two_pass_warp_fwd.register_fake
def _(img, theta, padding_mode, align_corners, row0=0, rows=-1):
    bsz, h, w, ch = img.shape
    return img.new_empty(bsz, h - row0 if rows < 0 else rows, w, ch)


def two_pass_warp(img: torch.Tensor, theta: torch.Tensor,
                  padding_mode: str = "zeros", align_corners: bool = False,
                  row0: int = 0, rows: Optional[int] = None) -> torch.Tensor:
    """Warp NHWC ``img`` (B, H, W, C) by affine ``theta`` (B, 2, 3); with
    a window, only the output rows ``row0 .. row0 + rows - 1``.

    ``img`` is float32 or bfloat16 and, on the card, a contiguous NHWC
    tensor (the ``permute(0, 2, 3, 1)`` view of a channels_last NCHW
    tensor is one). Returns a new (B, rows, W, C) tensor of ``img.dtype``
    (rows H by default), differentiable while grad mode is on.
    """
    check_warp_args(img, theta, padding_mode)
    row0, rows = window_of(img, row0, rows)
    if torch.is_grad_enabled() and (img.requires_grad or theta.requires_grad):
        return TwoPassWarp.apply(img, theta, padding_mode, align_corners,
                                 row0, rows)
    return two_pass_warp_fwd(img, theta, padding_mode, align_corners, row0,
                             rows)
