"""The banded ("fused") affine warp: wrapper of ``csrc/fused_warp.cu``
and its plain versions.

Replaces ``cadepth_tpu/ops/pallas/fused_warp.py``: the forward
``_fused_fwd_passes`` (``_fwd_v_banded_kernel``, then the two-pass
``_pass_h_kernel``; ``pallas_fused_warp`` and the forward of
``pallas_fused_warp_trainable``) and its backward
``_fused_trainable_bwd`` (the two-pass ``_bwd_h_kernel``, then
``_bwd_v_banded_kernel``, and the chain to d_theta), the PCL's
``warp_mode="fused"``.

The function is the two-pass warp's (``ops/affine_warp.py``) with a
banded pass V. Output rows are cut into tiles of ``it`` rows and columns
into strips of ``wt`` (:func:`fused_tiles`); each (tile, strip) cell
reads a static band of ``kb_f`` source rows whose base comes from the
cell's four corners, and the backward's transposed pass V reads ``kb_b``
rows of d_v per cell of d_img. Inside :func:`fused_warp_theta_ok` this
equals the two-pass warp up to f32 rounding (the tent positions are
written with other expressions); outside it the taps beyond the band
are dropped, and the port drops the same ones. Zeros padding only.

:func:`fused_warp` is differentiable in ``img`` and ``theta`` while grad
mode is on and either requires grad, through :class:`FusedWarp`, whose
forward also stores V for the backward; otherwise (serving) it launches
the forward alone, which keeps V in shared memory and writes none, as
the registered op ``cadepth::fused_warp_fwd`` (:func:`fused_warp_fwd`,
which ``torch.export`` traces as one node). For
a CUDA tensor the forward launches its kernel (one launch) and the
backward its three (the transposed passes, then the sum of their theta
partials and the chain to d_theta on the card), or raise; for a CPU
tensor they compute the plain versions, :func:`fused_warp_plain_fwd` and
:func:`fused_warp_plain_bwd`, which visit the same band rows as the
kernels. ``launches``, ``bwd_launches``, ``v_stores`` and
``grad_copies`` count as in ``ops/two_pass_warp.py``; the launch plan
(:func:`fused_plan`) depends on the shape alone.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from cadepth_tpu_torch.ops import _build
from cadepth_tpu_torch.ops.affine_warp import (
    _dtent,
    chain_theta_closed,
    check_warp_args,
    plain_pass_h,
    plain_pass_h_bwd,
    safe_divisor,
    warp_coeffs,
)
from cadepth_tpu_torch.ops.two_pass_warp import (
    DTYPE_CODE,
    ITEMSIZE,
    check_card_args,
    fwd_plan,
    raise_on,
    vector_width,
)

# Preferred output-row tile and column strip (the reference's defaults).
IT_PREF = 4
WT_PREF = 64

# Kernel launches since the counts were last set to 0.
launches = 0
bwd_launches = 0
LAUNCHES_PER_CALL = 1
BWD_LAUNCHES_PER_CALL = 3
# Forward launches that also stored V (training; serving stores none).
v_stores = 0
# Backward calls that copied a non-contiguous incoming gradient.
grad_copies = 0

# Threads of a kernel block (kThreads of csrc/warp_common.cuh), and the
# fewest blocks a launch is planned to have where splitting the channels
# allows it: about two for each of an H100's 132 SMs. A constant, not
# the card's SM count, so the plan, the block partials and d_theta's
# bits are the same on every card.
THREADS = 256
MIN_BLOCKS = 256

_VP = ctypes.c_void_p
_INT = ctypes.c_int


def _tile(n: int, pref: int) -> int:
    """Largest divisor of ``n`` not above ``pref``."""
    for t in range(min(pref, n), 0, -1):
        if n % t == 0:
            return t
    return 1


def fused_tiles(h: int, w: int) -> Tuple[int, int, int, int]:
    """(it, wt, kb_f, kb_b) of an (h, w) level: the row tile and column
    strip (largest divisors of h and w up to :data:`IT_PREF` and
    :data:`WT_PREF`) and the forward and backward band heights, clamped
    to h (a band of h rows is dense, hence exact)."""
    it = _tile(h, IT_PREF)
    wt = _tile(w, WT_PREF)
    return it, wt, min(it + 8, h), min(2 * it + 8, h)


def fused_warp_theta_ok(theta: torch.Tensor, height: int, width: int,
                        align_corners: bool = False) -> torch.Tensor:
    """(B,) bool: does the static band cover this theta exactly?

    Forward: |q|(it-1) + |p|(wt-1) + 2 <= kb_f - 1; backward:
    ((it-1) + |p|(wt-1) + 2) / max(|q|, 1e-3) + 2 <= kb_b - 1; a band
    clamped to the height is always exact.
    """
    it, wt, kb_f, kb_b = fused_tiles(height, width)
    co = warp_coeffs(theta, height, width, align_corners)
    doa, q = co[:, 3].abs(), co[:, 4].abs()
    fwd_ok = (q * (it - 1) + doa * (wt - 1) + 2.0) <= (kb_f - 1.0)
    span = (it - 1.0) + doa * (wt - 1)
    bwd_ok = (span + 2.0) / q.clamp_min(1e-3) + 2.0 <= (kb_b - 1.0)
    return (fwd_ok | (kb_f >= height)) & (bwd_ok | (kb_b >= height))


def check_fused_args(img: torch.Tensor, theta: torch.Tensor,
                     padding_mode: str) -> None:
    if padding_mode != "zeros":
        raise ValueError(
            "fused_warp supports only padding_mode='zeros' (the PCL's); "
            "border clamping makes the banded adjoint unbounded at the "
            f"edges. Got: {padding_mode}")
    check_warp_args(img, theta, padding_mode)


def fused_plan(batch: int, height: int, width: int, channels: int,
               dtype: torch.dtype, aligned: bool = True
               ) -> Tuple[int, int, int]:
    """(vec, c_chunk, smem_bytes) of the banded kernels' launches over a
    (batch, height, width, channels) map: the channels a thread moves
    (:func:`~cadepth_tpu_torch.ops.two_pass_warp.vector_width`), the
    channels one block holds for a whole row, and the bytes of that row
    chunk in shared memory.

    The chunk starts from the two-pass forward's
    (:func:`~cadepth_tpu_torch.ops.two_pass_warp.fwd_plan`) and halves
    again, in whole vectors, while the launch has fewer than
    :data:`MIN_BLOCKS` blocks and the halved chunk still gives each of a
    block's :data:`THREADS` threads two items (a pixel's vector each) of
    the row: the flagship's small decoder levels (a few rows of many
    channels) otherwise leave most SMs idle, and blocks of fewer items
    spend more of their time on their set-up and their barrier. A rule of
    the shape alone.
    """
    size = ITEMSIZE[dtype]
    vec = vector_width(channels, dtype, aligned)
    chunk, _ = fwd_plan(width, channels, dtype, aligned)
    while chunk and batch * height * -(-channels // chunk) < MIN_BLOCKS:
        half = max(vec, -(-(chunk // 2) // vec) * vec)
        if half == chunk or width * (half // vec) < 2 * THREADS:
            break
        chunk = half
    return vec, chunk, width * chunk * size


def _plan(img: torch.Tensor, *others: torch.Tensor) -> Tuple[int, int, int]:
    """:func:`fused_plan` of a launch over ``img`` and the other buffers
    of its shape and dtype (one channel a thread where one is not 16-byte
    aligned), checked against the kernel's int32 block count."""
    bsz, h, w, ch = img.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (img,) + others)
    plan = fused_plan(bsz, h, w, ch, img.dtype, aligned)
    if plan[1] and bsz * h * -(-ch // plan[1]) >= 2 ** 31:
        raise ValueError(f"img shape {tuple(img.shape)} needs more than "
                         "2^31 blocks")
    return plan


# -- plain versions -----------------------------------------------------------

def _band_base(lo: torch.Tensor, size: int, kb: int) -> torch.Tensor:
    """clip(floor(lo), 0, size - kb) as indices."""
    return torch.floor(lo).clamp(0.0, float(size - kb)).to(torch.long)


def _spans(n: int, cell: int, dev: torch.device):
    """(first, last) index of the cell of ``cell`` indices holding each of
    0..n-1, as f32 vectors."""
    lo = (torch.arange(n, device=dev) // cell * cell).to(torch.float32)
    return lo, (lo + float(cell)) - 1.0


def _min4(a, b, c, d):
    return torch.minimum(torch.minimum(a, b), torch.minimum(c, d))


def _max4(a, b, c, d):
    return torch.maximum(torch.maximum(a, b), torch.maximum(c, d))


def fused_warp_plain_fwd(img: torch.Tensor, theta: torch.Tensor,
                         align_corners: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, V) of the banded warp, in ``img.dtype``: the banded pass V
    (f32 tent weights, rounded to bf16 for bf16 features, f32 sums over
    the band rows in order, V stored in ``img.dtype``), then the
    two-pass warp's pass H."""
    check_fused_args(img, theta, "zeros")
    bsz, h, w, _ = img.shape
    it, wt, kb, _ = fused_tiles(h, w)
    dev = img.device
    co = warp_coeffs(theta, h, w, align_corners)
    p, q, r = (co[:, k, None, None] for k in (3, 4, 5))       # (B, 1, 1)
    i_lo, i_hi = (t[None, :, None] for t in _spans(h, it, dev))
    x_lo, x_hi = (t[None, None, :] for t in _spans(w, wt, dev))
    corner = lambda x, i: (p * x + q * i) + r                  # noqa: E731
    y0 = _band_base(_min4(corner(x_lo, i_lo), corner(x_hi, i_lo),
                          corner(x_lo, i_hi), corner(x_hi, i_hi)), h, kb)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ii = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    px, qi = p * xs, q * ii
    bi = torch.arange(bsz, device=dev)[:, None, None]
    xi = torch.arange(w, device=dev)[None, None, :]
    acc = torch.zeros(img.shape, dtype=torch.float32, device=dev)
    for k in range(kb):
        yk = y0 + k
        pos = (px + (r - yk.to(torch.float32))) + qi
        wk = (1.0 - pos.abs()).clamp_min(0.0)
        if img.dtype == torch.bfloat16:
            wk = wk.to(torch.bfloat16).to(torch.float32)
        acc = acc + wk[..., None] * img[bi, yk, xi].float()
    v = acc.to(img.dtype)
    return plain_pass_h(v, theta, "zeros", align_corners), v


def fused_warp_plain(img: torch.Tensor, theta: torch.Tensor,
                     padding_mode: str = "zeros",
                     align_corners: bool = False) -> torch.Tensor:
    """The banded warp's output, plain (the signature of
    :func:`fused_warp`, so a PCL can take it as its warp)."""
    check_fused_args(img, theta, padding_mode)
    return fused_warp_plain_fwd(img, theta, align_corners)[0]


def fused_warp_plain_bwd(img: torch.Tensor, v: torch.Tensor,
                         theta: torch.Tensor, grad_out: torch.Tensor,
                         align_corners: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_img in ``img.dtype``, d_theta f32) of the banded warp, given the
    forward's ``img``, V and ``theta`` and the cotangent ``grad_out``.

    d_v by the two-pass warp's transposed pass H, stored in
    ``img.dtype``; then for each cell of d_img the ``kb_b`` rows of d_v
    from the base that the cell's corners give, with the tent at
    ``diff = (p*x + (q*i + r)) - y`` (rounded to bf16 for bf16 features)
    and the partials ``<d_v, img> * dtent(diff) * (x, i, 1)`` (JAX's kink
    conventions), chained with pass H's to d_theta by
    :func:`~cadepth_tpu_torch.ops.affine_warp.chain_theta_closed`, the
    theta kernel's f32 arithmetic.
    """
    check_fused_args(img, theta, "zeros")
    bsz, h, w, _ = img.shape
    it, wt, _, kb = fused_tiles(h, w)
    dev = img.device
    d_v, part_h = plain_pass_h_bwd(v, theta, grad_out, "zeros",
                                   align_corners)
    co = warp_coeffs(theta, h, w, align_corners)
    p, q, r = (co[:, k, None, None] for k in (3, 4, 5))       # (B, 1, 1)
    q_safe = safe_divisor(q)
    y_lo, y_hi = (t[None, :, None] for t in _spans(h, it, dev))
    x_lo, x_hi = (t[None, None, :] for t in _spans(w, wt, dev))
    lo_r, hi_r = y_lo - r, y_hi - r
    t = (lo_r - p * x_lo, lo_r - p * x_hi, hi_r - p * x_lo, hi_r - p * x_hi)
    t_lo, t_hi = _min4(*t), _max4(*t)
    i0 = _band_base(_min4((t_lo - 1.0) / q_safe, (t_lo + 1.0) / q_safe,
                          (t_hi - 1.0) / q_safe, (t_hi + 1.0) / q_safe),
                    h, kb)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    yf = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    px = p * xs
    bi = torch.arange(bsz, device=dev)[:, None, None]
    xi = torch.arange(w, device=dev)[None, None, :]
    dvf, imf = d_v.float(), img.float()
    d_img = torch.zeros(img.shape, dtype=torch.float32, device=dev)
    c_r = torch.zeros(i0.shape, dtype=torch.float32, device=dev)
    c_q = torch.zeros_like(c_r)
    for k in range(kb):
        ik = i0 + k
        fi = ik.to(torch.float32)
        diff = (px + (q * fi + r)) - yf
        wk = (1.0 - diff.abs()).clamp_min(0.0)
        if img.dtype == torch.bfloat16:
            wk = wk.to(torch.bfloat16).to(torch.float32)
        dv_k = dvf[bi, ik, xi]
        d_img = d_img + wk[..., None] * dv_k
        contrib = (dv_k * imf).sum(-1) * _dtent(diff)
        c_r = c_r + contrib
        c_q = c_q + fi * contrib
    part_v = torch.stack([(c_r * xs).sum((1, 2)), c_q.sum((1, 2)),
                          c_r.sum((1, 2))], dim=-1)
    partials = torch.cat([part_h, part_v], dim=-1)             # (B, 6)
    return d_img.to(img.dtype), chain_theta_closed(theta, partials, h, w,
                                                   align_corners)


# -- kernels ------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = _build.library("fused_warp")
    if lib.cadepth_fused_warp_fwd.argtypes is None:
        lib.cadepth_fused_warp_fwd.argtypes = [_VP] * 4 + [_INT] * 12 + [_VP]
        lib.cadepth_fused_warp_fwd.restype = _INT
        lib.cadepth_fused_warp_bwd.argtypes = [_VP] * 8 + [_INT] * 12 + [_VP]
        lib.cadepth_fused_warp_bwd.restype = _INT
        lib.cadepth_cuda_error_string.argtypes = [_INT]
        lib.cadepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _forward(img: torch.Tensor, theta: torch.Tensor, align_corners: bool,
             keep_v: bool):
    """(out, V): the plain version on the CPU (V always), the kernel on
    the card (V only where ``keep_v``, else None)."""
    global launches, v_stores
    if img.device.type == "cpu":
        return fused_warp_plain_fwd(img, theta, align_corners)
    check_card_args(img, theta, "fused_warp")
    bsz, h, w, ch = img.shape
    it, wt, kb, _ = fused_tiles(h, w)
    theta = theta.to(torch.float32).contiguous()
    out = torch.empty_like(img)
    v = torch.empty_like(img) if keep_v else None
    plan = _plan(img, out, *([v] if keep_v else []))
    lib = _library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cadepth_fused_warp_fwd(
            img.data_ptr(), v.data_ptr() if keep_v else None, out.data_ptr(),
            theta.data_ptr(), bsz, h, w, ch, DTYPE_CODE[img.dtype],
            int(align_corners), it, wt, kb, *plan, stream)
    raise_on(lib, err, "fused_warp forward")
    launches += LAUNCHES_PER_CALL
    v_stores += int(keep_v)
    return out, v


def fused_warp_bwd(img: torch.Tensor, v: torch.Tensor, theta: torch.Tensor,
                   grad_out: torch.Tensor, align_corners: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_img, d_theta) of the banded warp, given the forward's ``img``,
    V and ``theta`` and the contiguous cotangent ``grad_out`` of its
    output.

    On the card: the two transposed passes and the theta kernel, which
    sums their per-block partials and chains them to d_theta; the host
    allocates and launches, nothing else. On the CPU:
    :func:`fused_warp_plain_bwd`.
    """
    global bwd_launches
    check_fused_args(img, theta, "zeros")
    if img.device.type == "cpu":
        return fused_warp_plain_bwd(img, v, theta, grad_out, align_corners)
    check_card_args(img, theta, "fused_warp")
    for name, t in (("v", v), ("grad_out", grad_out)):
        if t.shape != img.shape or t.dtype != img.dtype or \
                t.device != img.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {img.dtype} "
                             f"tensor of img's shape {tuple(img.shape)}")
    bsz, h, w, ch = img.shape
    it, wt, _, kb = fused_tiles(h, w)
    th = theta.to(torch.float32).contiguous()
    d_v = torch.empty_like(img)
    d_img = torch.empty_like(img)
    plan = _plan(img, v, grad_out, d_v, d_img)
    blocks = bsz * h * (-(-ch // plan[1]) if plan[1] else 0)
    part = torch.empty(2 * blocks * 3, dtype=torch.float32, device=img.device)
    d_theta = torch.empty(bsz, 2, 3, dtype=torch.float32, device=img.device)
    lib = _library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cadepth_fused_warp_bwd(
            grad_out.data_ptr(), v.data_ptr(), img.data_ptr(), th.data_ptr(),
            d_v.data_ptr(), d_img.data_ptr(), part.data_ptr(),
            d_theta.data_ptr(), bsz, h, w, ch, DTYPE_CODE[img.dtype],
            int(align_corners), it, wt, kb, *plan, stream)
    raise_on(lib, err, "fused_warp backward")
    bwd_launches += BWD_LAUNCHES_PER_CALL
    return d_img, d_theta


class FusedWarp(torch.autograd.Function):
    """The banded warp with the backward of ``_fused_trainable_bwd``."""

    @staticmethod
    def forward(ctx, img, theta, align_corners):
        out, v = _forward(img, theta, align_corners, keep_v=True)
        ctx.save_for_backward(img, v, theta)
        ctx.align_corners = align_corners
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        global grad_copies
        img, v, theta = ctx.saved_tensors
        # the kernels read contiguous NHWC only, so a strided gradient
        # (the PCL's permute back to NCHW, a channel slice of a cat) is
        # copied
        if not grad_out.is_contiguous():
            grad_copies += 1
        grad_out = grad_out.to(img.dtype).contiguous()
        d_img, d_theta = fused_warp_bwd(img, v, theta, grad_out,
                                        ctx.align_corners)
        return d_img, d_theta.to(theta.dtype), None


@torch.library.custom_op("cadepth::fused_warp_fwd", mutates_args=())
def fused_warp_fwd(img: torch.Tensor, theta: torch.Tensor,
                   align_corners: bool) -> torch.Tensor:
    """The banded warp's forward without V: the kernel for a CUDA tensor,
    the plain version for a CPU one."""
    return _forward(img, theta, align_corners, keep_v=False)[0]


@fused_warp_fwd.register_fake
def _(img, theta, align_corners):
    return torch.empty_like(img)


def fused_warp(img: torch.Tensor, theta: torch.Tensor,
               padding_mode: str = "zeros",
               align_corners: bool = False) -> torch.Tensor:
    """Warp NHWC ``img`` (B, H, W, C) by affine ``theta`` (B, 2, 3) with
    the banded pass V; ``padding_mode`` must be "zeros" (ValueError
    otherwise).

    ``img`` is float32 or bfloat16 and, on the card, a contiguous NHWC
    tensor. Returns a new (B, H, W, C) tensor of ``img.dtype``,
    differentiable while grad mode is on.
    """
    check_fused_args(img, theta, padding_mode)
    if torch.is_grad_enabled() and (img.requires_grad or theta.requires_grad):
        return FusedWarp.apply(img, theta, align_corners)
    return fused_warp_fwd(img, theta, align_corners)
