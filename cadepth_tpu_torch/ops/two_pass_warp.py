"""The two-pass affine warp on the card: wrapper of ``csrc/two_pass_warp.cu``.

Replaces ``cadepth_tpu/ops/pallas/two_pass_warp.py``: the forward
(``_pass_v_kernel`` and ``_pass_h_kernel``, and the XLA form of
``cadepth_tpu/ops/affine_warp.py: two_pass_affine_warp``) and the
backward of ``pallas_two_pass_warp_trainable`` (``_trainable_bwd``:
``_bwd_h_kernel`` and ``_bwd_v_kernel``).

:func:`two_pass_warp` is differentiable in ``img`` and ``theta`` while
grad mode is on: it goes through :class:`TwoPassWarp`, which keeps
``img``, V (pass V's result, which the forward writes anyway) and
``theta`` for the backward. Under ``torch.no_grad`` or
``torch.inference_mode`` it launches the forward alone, as serving does.

For a CUDA tensor the forward and the backward launch their kernels (two
launches each) or raise; for a CPU tensor they compute the plain
versions, :func:`~cadepth_tpu_torch.ops.affine_warp.
two_pass_affine_warp_plain_fwd` and ``two_pass_affine_warp_plain_bwd``.
``launches`` and ``bwd_launches`` count kernel launches, so a run can
show that its warps went through the kernels; ``grad_copies`` counts the
backward calls whose incoming gradient was not contiguous NHWC and was
copied before the launch.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from cadepth_tpu_torch.ops import _build
from cadepth_tpu_torch.ops.affine_warp import (
    chain_theta,
    check_warp_args,
    two_pass_affine_warp_plain_bwd,
    two_pass_affine_warp_plain_fwd,
)

# Kernel launches since the counts were last set to 0.
launches = 0
bwd_launches = 0
LAUNCHES_PER_CALL = 2
BWD_LAUNCHES_PER_CALL = 2
# Backward calls that copied a non-contiguous incoming gradient.
grad_copies = 0

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VP = ctypes.c_void_p
_INT = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = _build.library("two_pass_warp")
    if lib.cadepth_two_pass_warp_fwd.argtypes is None:
        lib.cadepth_two_pass_warp_fwd.argtypes = \
            [_VP] * 4 + [_INT] * 7 + [_VP]
        lib.cadepth_two_pass_warp_fwd.restype = _INT
        lib.cadepth_two_pass_warp_bwd.argtypes = \
            [_VP] * 8 + [_INT] * 7 + [_VP]
        lib.cadepth_two_pass_warp_bwd.restype = _INT
        lib.cadepth_two_pass_warp_bwd_stride.argtypes = [_INT, _INT]
        lib.cadepth_two_pass_warp_bwd_stride.restype = _INT
        lib.cadepth_cuda_error_string.argtypes = [_INT]
        lib.cadepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


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


def _forward(img: torch.Tensor, theta: torch.Tensor, padding_mode: str,
             align_corners: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, V): the plain version on the CPU, the kernel on the card."""
    global launches
    if img.device.type == "cpu":
        return two_pass_affine_warp_plain_fwd(img, theta, padding_mode,
                                              align_corners)
    check_card_args(img, theta)
    bsz, h, w, ch = img.shape
    theta = theta.to(torch.float32).contiguous()
    v = torch.empty_like(img)
    out = torch.empty_like(img)
    lib = _library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cadepth_two_pass_warp_fwd(
            img.data_ptr(), v.data_ptr(), out.data_ptr(), theta.data_ptr(),
            bsz, h, w, ch, DTYPE_CODE[img.dtype],
            int(padding_mode == "border"), int(align_corners), stream)
    raise_on(lib, err, "two_pass_warp forward")
    launches += LAUNCHES_PER_CALL
    return out, v


def two_pass_warp_bwd(img: torch.Tensor, v: torch.Tensor, theta: torch.Tensor,
                      grad_out: torch.Tensor, padding_mode: str = "zeros",
                      align_corners: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_img, d_theta) of the warp, given the forward's ``img``, V and
    ``theta`` and the contiguous cotangent ``grad_out`` of its output.

    On the card: the two backward kernels, then a sum of their per-block
    theta partials and the chain through the line coefficients. On the
    CPU: :func:`two_pass_affine_warp_plain_bwd`.
    """
    global bwd_launches
    check_warp_args(img, theta, padding_mode)
    if img.device.type == "cpu":
        return two_pass_affine_warp_plain_bwd(img, v, theta, grad_out,
                                              padding_mode, align_corners)
    check_card_args(img, theta)
    for name, t in (("v", v), ("grad_out", grad_out)):
        if t.shape != img.shape or t.dtype != img.dtype or \
                t.device != img.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {img.dtype} "
                             f"tensor of img's shape {tuple(img.shape)}")
    bsz, h, w, ch = img.shape
    th = theta.to(torch.float32).contiguous()
    lib = _library()
    stride = lib.cadepth_two_pass_warp_bwd_stride(w, ch)
    d_v = torch.empty_like(img)
    d_img = torch.empty_like(img)
    part = torch.empty(2, bsz, h * stride, 3, dtype=torch.float32,
                       device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cadepth_two_pass_warp_bwd(
            grad_out.data_ptr(), v.data_ptr(), img.data_ptr(), th.data_ptr(),
            d_v.data_ptr(), d_img.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), bsz, h, w, ch, DTYPE_CODE[img.dtype],
            int(padding_mode == "border"), int(align_corners), stream)
    raise_on(lib, err, "two_pass_warp backward")
    bwd_launches += BWD_LAUNCHES_PER_CALL
    partials = torch.cat([part[0].sum(1), part[1].sum(1)], dim=-1)  # (B, 6)
    return d_img, chain_theta(th, partials, h, w, align_corners)


class TwoPassWarp(torch.autograd.Function):
    """The warp with the backward of ``_trainable_bwd``."""

    @staticmethod
    def forward(ctx, img, theta, padding_mode, align_corners):
        out, v = _forward(img, theta, padding_mode, align_corners)
        ctx.save_for_backward(img, v, theta)
        ctx.padding_mode = padding_mode
        ctx.align_corners = align_corners
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
                                           ctx.align_corners)
        return d_img, d_theta.to(theta.dtype), None, None


def two_pass_warp(img: torch.Tensor, theta: torch.Tensor,
                  padding_mode: str = "zeros",
                  align_corners: bool = False) -> torch.Tensor:
    """Warp NHWC ``img`` (B, H, W, C) by affine ``theta`` (B, 2, 3).

    ``img`` is float32 or bfloat16 and, on the card, a contiguous NHWC
    tensor (the ``permute(0, 2, 3, 1)`` view of a channels_last NCHW
    tensor is one). Returns a new (B, H, W, C) tensor of ``img.dtype``,
    differentiable while grad mode is on.
    """
    check_warp_args(img, theta, padding_mode)
    if torch.is_grad_enabled():
        return TwoPassWarp.apply(img, theta, padding_mode, align_corners)
    return _forward(img, theta, padding_mode, align_corners)[0]
