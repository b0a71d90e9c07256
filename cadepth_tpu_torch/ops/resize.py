"""Resizing and pooling, NHWC (port of ``cadepth_tpu.ops.resize``).

Every function takes (..., H, W, C) tensors. The resizes follow torch's
index rules, as the reference's loader does: bilinear with
``align_corners=False`` (two f32 products with dense interpolation
matrices, built in numpy exactly as the JAX package builds them) and
the legacy ``nearest``. The pools drop the remainder rows and columns, as
torch's ``avg_pool2d``/``MaxPool2d`` with kernel = stride = factor do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) f32 row-interpolation matrix of the
    ``align_corners=False`` rule: src = (dst + 0.5) * in/out - 0.5,
    clamped to [0, in_size - 1]."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = np.clip((dst + 0.5) * scale - 0.5, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    w_lo = 1.0 - w_hi
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    mat[np.arange(out_size), lo] += w_lo.astype(np.float32)
    mat[np.arange(out_size), hi] += w_hi.astype(np.float32)
    return mat


@functools.lru_cache(maxsize=64)
def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output index, torch's legacy ``nearest``:
    floor(dst * in/out)."""
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size, dtype=np.float64) * scale)
    return np.minimum(idx.astype(np.int64), in_size - 1)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize (``align_corners=False``) of (..., H, W, C) to
    (..., height, width, C): H contracted, then W, in f32 (full f32
    products: the TF32 switch does not apply to ``torch.matmul`` by
    default), cast back to ``x.dtype``."""
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (in_h, in_w) == (height, width):
        return x
    lead, ch = x.shape[:-3], x.shape[-1]
    m_h = torch.from_numpy(_bilinear_matrix(in_h, height)).to(x.device)
    m_w = torch.from_numpy(_bilinear_matrix(in_w, width)).to(x.device)
    xf = x.float().reshape(lead + (in_h, in_w * ch))
    out = torch.matmul(m_h, xf).reshape(lead + (height, in_w, ch))
    return torch.matmul(m_w, out).to(x.dtype)


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Nearest-neighbour resize of (..., H, W, C), torch's legacy rule
    (the reference's loader resizes depth maps so)."""
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (in_h, in_w) == (height, width):
        return x
    rows = torch.from_numpy(_nearest_indices(in_h, height)).to(x.device)
    cols = torch.from_numpy(_nearest_indices(in_w, width)).to(x.device)
    return x.index_select(-3, rows).index_select(-2, cols)


def _windows(x: torch.Tensor, factor: int) -> torch.Tensor:
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = h // factor, w // factor
    x = x[..., : oh * factor, : ow * factor, :]
    return x.reshape(x.shape[:-3] + (oh, factor, ow, factor, x.shape[-1]))


def avg_pool2d(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average pool with window = stride = factor."""
    if factor <= 1:
        return x
    return _windows(x, factor).mean(dim=(-4, -2))


def max_pool2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Max pool with window = stride = factor."""
    if factor <= 1:
        return x
    return _windows(x, factor).amax(dim=(-4, -2))
