"""Bilinear grid sampling and affine grids, NHWC (port of
``cadepth_tpu.ops.grid_sample``).

The JAX package writes ``grid_sample`` as four vectorised gathers blended
in f32 (XLA has no grid-sample op), and the PCL's ``gather`` mode warps
through ``grid_sample(img, affine_grid(theta))``. This module repeats
that arithmetic in stock PyTorch on both devices, differentiated by
autograd:

* pixel positions from ``_unnormalize`` as written, the corners gathered
  in the input dtype, blended in f32 in the order (x0, y0) + (x1, y0) +
  (x0, y1) + (x1, y1), and the sum cast back;
* ``affine_grid`` as explicit f32 multiply-adds over a base grid built in
  numpy f32 (JAX's einsum runs at ``precision="highest"``; a
  ``torch.einsum`` would be a batched matmul whose precision follows the
  TF32 switches);
* JAX's derivative conventions at kinks: ``clip`` through
  ``torch.maximum``/``torch.minimum``, which give half the gradient at a
  tie, as ``jnp.clip`` does.

``F.grid_sample`` computes the same function with other round-off and is
not used here: ``chip_smoke.py`` times it only as a yardstick.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PADDING_MODES = ("zeros", "border")


def jax_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum then minimum, half the gradient at a tie."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _unnormalize(coord: torch.Tensor, size: int,
                 align_corners: bool) -> torch.Tensor:
    """[-1, 1] grid coordinates -> pixel coordinates (torch's rules)."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _gather_2d(img: torch.Tensor, iy: torch.Tensor,
               ix: torch.Tensor) -> torch.Tensor:
    """img[b, iy, ix, :] for (B, Ho, Wo) index maps already in range.

    Flat advanced indexing: one (B, Ho*Wo) index, not an index expanded
    over the channels (8 bytes per element of the output)."""
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    idx = (iy * w + ix).reshape(b, -1)
    rows = torch.arange(b, device=img.device)[:, None]
    return flat[rows, idx].reshape(b, iy.shape[1], iy.shape[2], c)


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "zeros",
                align_corners: bool = False) -> torch.Tensor:
    """Bilinear sample NHWC ``img`` (B, H, W, C) at ``grid`` (B, Ho, Wo, 2),
    whose last axis is (x, y) in [-1, 1]; ``padding_mode`` "zeros" (taps
    outside the image add nothing) or "border" (positions clamped to the
    edge). Returns (B, Ho, Wo, C) in ``img.dtype``."""
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"Unsupported padding_mode: {padding_mode}")
    b, h, w, _ = img.shape
    gx = grid[..., 0].float()
    gy = grid[..., 1].float()
    px = _unnormalize(gx, w, align_corners)
    py = _unnormalize(gy, h, align_corners)
    if padding_mode == "border":
        px = jax_clip(px, 0.0, w - 1.0)
        py = jax_clip(py, 0.0, h - 1.0)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = px - x0
    wx0 = 1.0 - wx1
    wy1 = py - y0
    wy0 = 1.0 - wy1
    zero = px.new_zeros(())

    def corner(xi, yi, wgt):
        if padding_mode == "zeros":
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            wgt = torch.where(valid, wgt, zero)
        ix = xi.clamp(0, w - 1).long()
        iy = yi.clamp(0, h - 1).long()
        return _gather_2d(img, iy, ix).float() * wgt[..., None]

    out = (corner(x0, y0, wx0 * wy0) + corner(x1, y0, wx1 * wy0)
           + corner(x0, y1, wx0 * wy1) + corner(x1, y1, wx1 * wy1))
    return out.to(img.dtype)


@functools.lru_cache(maxsize=64)
def _base_axis(size: int, align_corners: bool) -> np.ndarray:
    """Normalised centres of ``size`` pixels, f32, as JAX computes them:
    ``linspace(-1, 1)`` (start (1 - s) + stop s, s = k / (size - 1), the
    last point exactly 1) or (2k + 1) / size - 1."""
    f32 = np.float32
    if align_corners:
        if size == 1:
            return np.full(1, -1.0, f32)
        s = np.arange(size - 1, dtype=f32) / f32(size - 1)
        out = f32(-1.0) * (f32(1.0) - s) + f32(1.0) * s
        return np.concatenate([out, np.ones(1, f32)])
    return (f32(2.0) * np.arange(size, dtype=f32) + f32(1.0)) / f32(size) \
        - f32(1.0)


def affine_grid(theta: torch.Tensor, height: int, width: int,
                align_corners: bool = False) -> torch.Tensor:
    """(B, height, width, 2) sampling grid, last axis (x, y), of the
    (B, 2, 3) affine ``theta`` acting on normalised output coordinates:
    ``(t[i,0] x + t[i,1] y) + t[i,2]``, in f32."""
    t = theta.float()
    dev = t.device
    xs = torch.from_numpy(_base_axis(width, align_corners)).to(dev)
    ys = torch.from_numpy(_base_axis(height, align_corners)).to(dev)
    gx, gy = xs[None, None, :], ys[None, :, None]
    rows = [(t[:, i, 0, None, None] * gx + t[:, i, 1, None, None] * gy)
            + t[:, i, 2, None, None] for i in (0, 1)]
    return torch.stack(rows, dim=-1)


def gather_affine_warp(img: torch.Tensor, theta: torch.Tensor,
                       padding_mode: str = "zeros",
                       align_corners: bool = False) -> torch.Tensor:
    """``grid_sample(img, affine_grid(theta))`` with the output the size
    of the input: the PCL's ``gather`` warp (the signature of the port's
    other warps)."""
    grid = affine_grid(theta, img.shape[1], img.shape[2], align_corners)
    return grid_sample(img, grid, padding_mode, align_corners)
