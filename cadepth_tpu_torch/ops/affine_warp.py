"""Affine warps: the two-pass warp's coefficients and plain PyTorch
version, and the separable warp (:func:`separable_affine_warp`, the PCL's
``separable`` mode, plain PyTorch products as in JAX).

Port of ``cadepth_tpu.ops.affine_warp``. The source position of output
pixel (row i, col j) is ``px = A j + B i + C``, ``py = D j + E i + F``
(pixel units, torch ``affine_grid`` convention). The two-pass
decomposition resamples columns first, then rows:

  V[b,i,x,c]   = sum_y tent(g(x,i) - y) * img[b,y,x,c],  g = p x + q i + r
  out[b,i,j,c] = sum_x tent(h(j,i) - x) * V[b,i,x,c],    h = A j + B i + C
  tent(d) = max(1 - |d|, 0),  p = D/A_safe,  q = E - p B,  r = F - p C

Under rotation (D != 0) the first pass's tent is sheared, so the result
differs from a bilinear ``grid_sample``; the port reproduces the two-pass
numbers, not grid_sample's.

:func:`two_pass_affine_warp_plain` is the plain version of the CUDA
kernel in ``csrc/two_pass_warp.cu``: the same two taps per output, the
same f32 tap weights ``max(1 - |pos - y|, 0)``, weights rounded to bf16
for bf16 features, f32 sums, and V stored in the feature dtype between
the passes. CPU tensors take it; ``chip_smoke.py`` holds the kernel
against it on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cadepth_tpu_torch.ops.grid_sample import jax_clip

PADDING_MODES = ("zeros", "border")


def affine_pixel_coeffs(theta: torch.Tensor, height: int, width: int,
                        align_corners: bool = False
                        ) -> Tuple[torch.Tensor, ...]:
    """Pixel-space coefficients (A..F) of a torch-convention affine grid.

    ``theta`` is (B, 2, 3) acting on normalized output coords in [-1, 1].
    Returns six (B,) f32 tensors.

    The two divisions divide by a tensor on theta's device, not by a
    Python float: PyTorch's CUDA division by a Python float multiplies by
    its reciprocal, which can differ from the division by one bit, and so
    would make the coefficients depend on the device.
    """
    t = theta.to(torch.float32)
    h, w = float(height), float(width)
    if align_corners:
        a = t[:, 0, 0]
        b = t[:, 0, 1] * (w - 1.0) / t.new_tensor(h - 1.0)
        c = (w - 1.0) / 2.0 * (-t[:, 0, 0] - t[:, 0, 1] + t[:, 0, 2] + 1.0)
        d = t[:, 1, 0] * (h - 1.0) / t.new_tensor(w - 1.0)
        e = t[:, 1, 1]
        f = (h - 1.0) / 2.0 * (-t[:, 1, 0] - t[:, 1, 1] + t[:, 1, 2] + 1.0)
    else:
        a = t[:, 0, 0]
        b = t[:, 0, 1] * w / t.new_tensor(h)
        c = (w / 2.0) * (t[:, 0, 0] * (1.0 / w - 1.0)
                         + t[:, 0, 1] * (1.0 / h - 1.0)
                         + t[:, 0, 2] + 1.0) - 0.5
        d = t[:, 1, 0] * h / t.new_tensor(w)
        e = t[:, 1, 1]
        f = (h / 2.0) * (t[:, 1, 0] * (1.0 / w - 1.0)
                         + t[:, 1, 1] * (1.0 / h - 1.0)
                         + t[:, 1, 2] + 1.0) - 0.5
    return a, b, c, d, e, f


def safe_divisor(x: torch.Tensor) -> torch.Tensor:
    """x with |x| >= 1e-3 and x's sign, as the reference's ``a_safe`` and
    ``q_safe``."""
    return torch.where(x.abs() < 1e-3,
                       torch.where(x < 0, -1e-3, 1e-3).to(x.dtype), x)


def warp_coeffs(theta: torch.Tensor, height: int, width: int,
                align_corners: bool = False) -> torch.Tensor:
    """(B, 6) f32 rows [A, B, C, p, q, r]: the pass-H and pass-V lines.

    ``A_safe`` keeps |A| >= 1e-3 with A's sign, as the reference does, so
    ``p = D / A_safe`` stays finite when the predicted x-scale collapses.
    """
    a, b, c, d, e, f = affine_pixel_coeffs(theta, height, width,
                                           align_corners)
    p = d / safe_divisor(a)
    return torch.stack([a, b, c, p, e - p * b, f - p * c], dim=-1)


def _taps(pos: torch.Tensor, size: int, border: bool, bf16: bool):
    """Indices and weights of the (at most) two taps of ``tent(pos - y)``.

    Returns clamped integer indices (y0, y1) and weights (w0, w1) that are
    zero where the tap lies outside [0, size - 1] (zeros padding).
    """
    if border:
        pos = pos.clamp(0.0, size - 1.0)
    y0 = torch.floor(pos)
    y1 = y0 + 1.0
    w0 = (1.0 - (pos - y0).abs()).clamp_min(0.0)
    w1 = (1.0 - (pos - y1).abs()).clamp_min(0.0)
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    w0 = torch.where((y0 >= 0.0) & (y0 <= size - 1.0), w0, zero)
    w1 = torch.where((y1 >= 0.0) & (y1 <= size - 1.0), w1, zero)
    if bf16:
        w0 = w0.to(torch.bfloat16).to(torch.float32)
        w1 = w1.to(torch.bfloat16).to(torch.float32)
    i0 = y0.clamp(0.0, size - 1.0).to(torch.long)
    i1 = y1.clamp(0.0, size - 1.0).to(torch.long)
    return i0, i1, w0, w1


def check_warp_args(img: torch.Tensor, theta: torch.Tensor,
                    padding_mode: str) -> None:
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"Unsupported padding_mode: {padding_mode}")
    if img.dim() != 4:
        raise ValueError(f"img must be (B, H, W, C), got {tuple(img.shape)}")
    if tuple(theta.shape) != (img.shape[0], 2, 3):
        raise ValueError(f"theta must be ({img.shape[0]}, 2, 3), "
                         f"got {tuple(theta.shape)}")
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"img must be float32 or bfloat16, got {img.dtype}")


def two_pass_affine_warp_plain(img: torch.Tensor, theta: torch.Tensor,
                               padding_mode: str = "zeros",
                               align_corners: bool = False) -> torch.Tensor:
    """Warp NHWC ``img`` (B, H, W, C) by ``theta`` (B, 2, 3) in two passes.

    Same function as the CUDA kernel and as the reference's
    ``two_pass_affine_warp``; returns (B, H, W, C) in ``img.dtype``.
    """
    return two_pass_affine_warp_plain_fwd(img, theta, padding_mode,
                                          align_corners)[0]


def _positions(theta: torch.Tensor, h: int, w: int, align_corners: bool,
               dev: torch.device, row0: int = 0, rows: Optional[int] = None):
    """(g, hpos), each (B, rows, W) f32: the pass-V position g(x, i) at
    [b, i - row0, x] and the pass-H position h(j, i) at [b, i - row0, j]
    for the output rows i = row0 .. row0 + rows - 1 of an (h, w) map
    (rows None: all of them), with the kernel's operation order."""
    rows = h - row0 if rows is None else rows
    co = warp_coeffs(theta, h, w, align_corners)
    a, b, c, p, q, r = (co[:, k, None, None] for k in range(6))
    ii = torch.arange(row0, row0 + rows, dtype=torch.float32,
                      device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    return p * xs + q * ii + r, a * xs + b * ii + c


def two_pass_affine_warp_plain_fwd(img: torch.Tensor, theta: torch.Tensor,
                                   padding_mode: str = "zeros",
                                   align_corners: bool = False,
                                   row0: int = 0, rows: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`two_pass_affine_warp_plain` that also returns V, the result
    of pass V in ``img.dtype`` (the backward's residual). With a window,
    both cover only the output rows ``row0 .. row0 + rows - 1`` (B, rows,
    W, C): those rows of the whole warp, bit for bit."""
    check_warp_args(img, theta, padding_mode)
    bsz, h, w, _ = img.shape
    border = padding_mode == "border"
    bf16 = img.dtype == torch.bfloat16
    dev = img.device
    g, _ = _positions(theta, h, w, align_corners, dev, row0, rows)
    bi = torch.arange(bsz, device=dev)[:, None, None]
    xi = torch.arange(w, device=dev)[None, None, :]

    # pass V: for each (b, i, x), two source rows y of column x
    y0, y1, w0, w1 = _taps(g, h, border, bf16)
    v = (w0[..., None] * img[bi, y0, xi].float()
         + w1[..., None] * img[bi, y1, xi].float()).to(img.dtype)
    return plain_pass_h(v, theta, padding_mode, align_corners, h, row0), v


def plain_pass_h(v: torch.Tensor, theta: torch.Tensor, padding_mode: str,
                 align_corners: bool, height: Optional[int] = None,
                 row0: int = 0) -> torch.Tensor:
    """Pass H of the warp over V (B, rows, W, C), the output rows
    ``row0 ..`` of a map of ``height`` rows (default: V's own, the whole
    map): for each (b, i, j), the two taps of row i of V at ``h(j, i)``;
    returns ``v.dtype``. The banded warp (``ops/fused_warp.py``) shares
    it."""
    bsz, rows, w, _ = v.shape
    dev = v.device
    _, hpos = _positions(theta, rows if height is None else height, w,
                         align_corners, dev, row0, rows)
    x0, x1, u0, u1 = _taps(hpos, w, padding_mode == "border",
                           v.dtype == torch.bfloat16)
    bi = torch.arange(bsz, device=dev)[:, None, None]
    ri = torch.arange(rows, device=dev)[None, :, None]
    out = (u0[..., None] * v[bi, ri, x0].float()
           + u1[..., None] * v[bi, ri, x1].float())
    return out.to(v.dtype)


def plain_pass_h_bwd(v: torch.Tensor, theta: torch.Tensor,
                     grad_out: torch.Tensor, padding_mode: str,
                     align_corners: bool, height: Optional[int] = None,
                     row0: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transposed pass H: (d_v in ``v.dtype``, (B, 3) f32 partials
    ``(sum c*j, i*sum c, sum c)`` of the pass-H line [A, B, C]) given V
    and the cotangent of the warp's output, as :func:`_transpose_pass`
    computes them; V and the cotangent may be a window of output rows, as
    for :func:`plain_pass_h`. The banded warp's backward shares it."""
    _, rows, w, _ = v.shape
    dev = v.device
    _, hpos = _positions(theta, rows if height is None else height, w,
                         align_corners, dev, row0, rows)
    ii = torch.arange(row0, row0 + rows, dtype=torch.float32,
                      device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    d_v, c_h = _transpose_pass(hpos, w, padding_mode == "border",
                               grad_out.float(), v.float(), rows=False)
    partials = torch.stack([(c_h * xs).sum((1, 2)), (c_h * ii).sum((1, 2)),
                            c_h.sum((1, 2))], dim=-1)
    return d_v.to(v.dtype), partials


def _dtent(diff: torch.Tensor) -> torch.Tensor:
    """d/dpos of max(1 - |pos - grid|, 0) with JAX's kink conventions:
    abs'(0) = +1, so -1 at diff == 0, and a max tie of weight 0.5, so
    -0.5 / +0.5 at diff == +1 / -1 (the reference's ``_dtent``)."""
    ad = diff.abs()
    mag = torch.where(ad < 1.0, 1.0, torch.where(ad == 1.0, 0.5, 0.0))
    return torch.where(diff >= 0.0, -mag, mag)


def _dclip(pos: torch.Tensor, size: int) -> torch.Tensor:
    """d/dpos of clip(pos, 0, size - 1) with JAX's convention: 1 inside,
    0 outside, 0.5 at the exact bounds (the reference's ``_dclip``)."""
    hi = size - 1.0
    return torch.where((pos > 0.0) & (pos < hi), 1.0,
                       torch.where((pos == 0.0) | (pos == hi), 0.5, 0.0))


def _transpose_pass(pos: torch.Tensor, size: int, border: bool,
                    cot: torch.Tensor, src: torch.Tensor, rows: bool):
    """One pass of the backward, for the pass whose (B, H, W) positions
    are ``pos`` and whose taps index an axis of length ``size``.

    ``cot`` (B, H, W, C) f32 is the cotangent of the pass's output and
    ``src`` f32 its input: (B, H, W, C) for pass H, and (B, size, W, C)
    for pass V, whose H output rows may be a window of the map. The taps
    index ``src``'s rows (axis 1, pass V) when ``rows``, else its columns
    (axis 2, pass H).
    Returns the cotangent of ``src`` (the transposed pass, f32 tent
    weights) and ``contrib`` (B, H, W): for each output position, the sum
    of ``<cot, src at the tap> * dtent * dclip`` over its taps inside
    [0, size - 1].

    The taps visited are ``floor(pos) - 1 .. floor(pos) + 2``: the tent's
    derivative is non-zero on the closed interval |pos - y| <= 1, three
    taps at an integer position, and for |pos| < 1 the f32 difference
    ``pos - (floor(pos) + 2)`` can round to exactly -1 (pos = -3e-8 gives
    a tie at y = 1), where the reference's dense difference matrix counts
    it with weight 0.5.
    """
    bsz, h, w, ch = cot.shape
    dev = cot.device
    pp = pos.clamp(0.0, size - 1.0) if border else pos
    base = torch.floor(pp)
    dclip = _dclip(pos, size) if border else None
    b_idx = torch.arange(bsz, device=dev)[:, None, None]
    i_idx = torch.arange(h, device=dev)[None, :, None]
    x_idx = torch.arange(w, device=dev)[None, None, :]
    src_h = src.shape[1]
    d_src = torch.zeros(bsz * src_h * w, ch, dtype=torch.float32, device=dev)
    contrib = torch.zeros_like(pos)
    for k in (-1.0, 0.0, 1.0, 2.0):
        tap = base + k
        inside = (tap >= 0.0) & (tap <= size - 1.0)
        diff = pp - tap
        t_idx = tap.clamp(0.0, size - 1.0).to(torch.long)
        if rows:
            flat = (b_idx * src_h + t_idx) * w + x_idx
        else:
            flat = (b_idx * h + i_idx) * w + t_idx
        at_tap = src.reshape(-1, ch)[flat]                    # (B, H, W, C)
        wgt = torch.where(inside, (1.0 - diff.abs()).clamp_min(0.0), 0.0)
        d_src.index_add_(0, flat.reshape(-1),
                         (wgt[..., None] * cot).reshape(-1, ch))
        slope = torch.where(inside, _dtent(diff), 0.0)
        if border:
            slope = slope * dclip
        contrib = contrib + (cot * at_tap).sum(-1) * slope
    return d_src.reshape(bsz, src_h, w, ch), contrib


def two_pass_affine_warp_plain_bwd(img: torch.Tensor, v: torch.Tensor,
                                   theta: torch.Tensor,
                                   grad_out: torch.Tensor,
                                   padding_mode: str = "zeros",
                                   align_corners: bool = False,
                                   row0: int = 0, rows: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of the two-pass warp: (d_img, d_theta).

    ``img`` (B, H, W, C), ``v`` the forward's pass-V result and
    ``grad_out`` the cotangent of its output, all in ``img.dtype``;
    ``theta`` (B, 2, 3). With a window of output rows ``row0 .. row0 +
    rows - 1``, ``v`` and ``grad_out`` are (B, rows, W, C), and d_img
    (the whole input's) and d_theta are that window's part: the windows
    of a partition of H sum to the whole map's backward. Computes what
    the reference's ``_trainable_bwd``
    (Pallas) computes, in the same order: ``d_v`` by the transposed
    pass H, stored in ``img.dtype``; ``d_img`` by the transposed pass V
    from that stored ``d_v``; both with f32 tent weights and f32 sums.
    ``d_theta`` (f32) chains six per-batch partials through
    :func:`warp_coeffs` (:func:`chain_theta_closed`, the theta kernel's
    arithmetic): ``(sum c*j, i*sum c, sum c)`` of the pass-H
    line and ``(x*sum c, sum c*i, sum c)`` of the pass-V line, where
    ``c`` is the channel dot product times the tent's derivative at each
    tap, with JAX's kink conventions (:func:`_dtent`,
    :func:`_dclip`). It does not differentiate the forward with torch's
    autograd, whose abs'(0) = 0 and full clamp gradient at the bounds
    differ from JAX's at the identity theta the PCL starts from.
    """
    check_warp_args(img, theta, padding_mode)
    _, h, w, _ = img.shape
    rows = h - row0 if rows is None else rows
    border = padding_mode == "border"
    dev = img.device
    g, _ = _positions(theta, h, w, align_corners, dev, row0, rows)
    ii = torch.arange(row0, row0 + rows, dtype=torch.float32,
                      device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]

    d_v, part_h = plain_pass_h_bwd(v, theta, grad_out, padding_mode,
                                   align_corners, h, row0)
    d_img, c_g = _transpose_pass(g, h, border, d_v.float(), img.float(),
                                 rows=True)
    partials = torch.cat([part_h, torch.stack([
        (c_g * xs).sum((1, 2)), (c_g * ii).sum((1, 2)), c_g.sum((1, 2)),
    ], dim=-1)], dim=-1)                                      # (B, 6)
    return d_img.to(img.dtype), chain_theta_closed(theta, partials, h, w,
                                                    align_corners)


def chain_theta_closed(theta: torch.Tensor, partials: torch.Tensor,
                       height: int, width: int,
                       align_corners: bool) -> torch.Tensor:
    """d_theta (B, 2, 3) f32 from the (B, 6) partials of the loss with
    respect to the six line coefficients [A, B, C, p, q, r]: the
    derivative of :func:`warp_coeffs` written out, in the f32 operation
    order of the warp kernels' theta kernel (``csrc/warp_common.cuh:
    chain_to_theta``), so the plain backward and the kernels share their
    arithmetic (``tests/test_torch_warp_chain.py`` holds it to autograd
    through :func:`warp_coeffs` and to JAX's chain).

    p = D / A_safe reaches the loss directly and through q = E - p B and
    r = F - p C, so its gradient is ``gp = (s_p - s_q B) - s_r C``; A
    takes ``s_a - gp p / A_safe`` where A_safe = A and ``s_a`` where the
    clamp holds A_safe at +-1e-3 (no gradient through it, as
    :func:`safe_divisor`'s ``where``). B = (t01 w) / h and D = (t10 h) / w
    scale their gradients by w/h and h/w; C and F are affine in theta
    with the constants of :func:`affine_pixel_coeffs`. The constants are
    f32 tensors and every division is by a tensor (the card's division
    by a Python float multiplies by its reciprocal).
    """
    t = theta.to(torch.float32)
    s_a, s_b, s_c, s_p, s_q, s_r = partials.to(torch.float32).unbind(-1)
    _, b, c, p, _, _ = warp_coeffs(t, height, width,
                                   align_corners).unbind(-1)
    a = t[:, 0, 0]
    a_safe = safe_divisor(a)
    h, w = float(height), float(width)
    if align_corners:
        w, h = w - 1.0, h - 1.0
    k = {name: t.new_tensor(value) for name, value in (
        ("w", w), ("h", h), ("hw", w / 2.0), ("hh", h / 2.0))}
    gp = (s_p - s_q * b) - s_r * c
    ga = torch.where(a.abs() < 1e-3, s_a, s_a - gp * p / a_safe)
    gb = s_b - s_q * p
    gc = s_c - s_r * p
    gd = gp / a_safe
    bw = gb / k["h"] * k["w"]
    dh = gd / k["w"] * k["h"]
    gcs = gc * k["hw"]
    gfs = s_r * k["hh"]
    if align_corners:
        rows = [ga - gcs, bw - gcs, gcs, dh - gfs, s_q - gfs, gfs]
    else:
        kx, ky = t.new_tensor(1.0 / w - 1.0), t.new_tensor(1.0 / h - 1.0)
        rows = [ga + gcs * kx, bw + gcs * ky, gcs,
                dh + gfs * kx, s_q + gfs * ky, gfs]
    return torch.stack(rows, dim=-1).reshape(-1, 2, 3)


# -- the separable warp -------------------------------------------------------

def _tent(pos: torch.Tensor, size: int, padding_mode: str,
          dtype: torch.dtype) -> torch.Tensor:
    """(..., size) tent weights ``max(1 - |pos - k|, 0)`` of ``pos``
    against k = 0..size-1, cast to ``dtype``; "border" clips ``pos`` to
    [0, size - 1] first. Written so that autograd takes JAX's kinks:
    abs'(0) = +1, half the gradient at a max or clip tie."""
    if padding_mode == "border":
        pos = jax_clip(pos, 0.0, size - 1.0)
    elif padding_mode != "zeros":
        raise ValueError(f"Unsupported padding_mode: {padding_mode}")
    grid = torch.arange(size, dtype=torch.float32, device=pos.device)
    d = pos[..., None] - grid
    w = torch.maximum(1.0 - torch.where(d >= 0.0, d, -d), d.new_zeros(()))
    return w.to(dtype)


def _mat_dtype(img_dtype: torch.dtype) -> torch.dtype:
    """Tent weights in the data's dtype: f32 and f64 stay, others bf16."""
    return img_dtype if img_dtype in (torch.float32, torch.float64) \
        else torch.bfloat16


def separable_affine_warp(img: torch.Tensor, theta: torch.Tensor,
                          padding_mode: str = "zeros",
                          align_corners: bool = False) -> torch.Tensor:
    """Axis-aligned affine warp of NHWC ``img`` (B, H, W, C) as two
    products with one tent matrix per sample and axis (port of the
    reference's ``separable_affine_warp``; the PCL's ``separable`` mode).

    Only scale and translation are kept (``px = A j + C``,
    ``py = E i + F``): the rotation and shear terms of ``theta`` are
    ignored, as in JAX. The products accumulate in f32 and round to the
    matrices' dtype (bf16 for bf16 data) after each pass; the result is
    cast to ``img.dtype``. Differentiable in ``img`` and ``theta`` by
    autograd, as the reference is by plain autodiff.
    """
    bsz, h, w, ch = img.shape
    dt = _mat_dtype(img.dtype)
    a, _, c, _, e, f = affine_pixel_coeffs(theta, h, w, align_corners)
    dev = img.device
    iis = torch.arange(h, dtype=torch.float32, device=dev)
    js = torch.arange(w, dtype=torch.float32, device=dev)
    py = e[:, None] * iis[None, :] + f[:, None]               # (B, Ho)
    px = a[:, None] * js[None, :] + c[:, None]                # (B, Wo)
    mv = _tent(py, h, padding_mode, dt)                       # (B, Ho, H)
    mh = _tent(px, w, padding_mode, dt)                       # (B, Wo, W)
    # pass V: out[b, i, (x, c)] = sum_y mv[b, i, y] img[b, y, (x, c)]
    v = torch.bmm(mv, img.to(dt).reshape(bsz, h, w * ch))
    # pass H: out[b, i, j, c] = sum_x mh[b, j, x] v[b, i, x, c]
    out = torch.matmul(mh[:, None], v.reshape(bsz, h, w, ch))
    return out.to(img.dtype)
