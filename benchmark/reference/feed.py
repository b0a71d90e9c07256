"""The training feed's batches, worked out again from the seeded scenes:
the epoch's order and augmentation draws, the storage's rounding, and
crop, flip and colour jitter with the camera-consistent K updates.

The rules are the SUN RGB-D loader's, as the configuration's feed states
them: an epoch's order is ``default_rng([seed, epoch])``'s shuffle of the
rows; its draws are one float32 table from ``default_rng([seed, epoch,
0x61756731])`` (crop scale, the crop's x and y offset uniforms, the flip
uniform, brightness, contrast; the three ranges mapped as ``max(lo, u *
(hi - lo) + lo)``). The crop keeps ``floor(scale * size)`` pixels at an
offset ``floor(u * (max(1, size - crop) + 1))`` (clamped to the image),
colour is jittered (``clip(rgb * contrast + brightness - 1, 0, 1)``)
before the bilinear resize back (half-pixel centres, rows then columns),
depth is resized by nearest, and K follows crop, flip and scale.
Quantized storage holds rgb as ``rint(255 x)`` bytes and depth as
``rint(1000 m)`` millimetres.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

DRAW_TAG = 0x61756731


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    order = np.arange(n)
    np.random.default_rng([seed, epoch]).shuffle(order)
    return order


def epoch_draws(seed: int, epoch: int, n: int, aug: Dict) -> np.ndarray:
    u = np.random.default_rng([seed, epoch, DRAW_TAG]).random(
        (n, 6), dtype=np.float32)
    out = u.copy()
    for col, lo, hi in ((0, aug["crop_scale_min"], aug["crop_scale_max"]),
                        (4, 1.0 - aug["brightness"], 1.0 + aug["brightness"]),
                        (5, 1.0 - aug["contrast"], 1.0 + aug["contrast"])):
        lo, hi = np.float32(lo), np.float32(hi)
        out[:, col] = np.maximum(lo, u[:, col] * (hi - lo) + lo)
    return out


def stored(rgb: torch.Tensor, depth: torch.Tensor, quantized: bool):
    """The scenes as the feed's storage gives them back, float32."""
    if not quantized:
        return rgb, depth
    q = torch.round(rgb * 255.0).to(torch.uint8)
    rgb = q.to(torch.float32) * (1.0 / 255.0)
    mm = torch.round(depth.clamp(0.0, 65.535) * 1000.0)
    return rgb, mm / mm.new_full((), 1000.0)


def _axis(out_size: int, crop0, crop_len, flip):
    dst = torch.arange(out_size, dtype=torch.float32,
                       device=crop_len.device)[None, :]
    scale = (crop_len / torch.full_like(crop_len, out_size))[:, None]
    top = (crop_len - 1.0)[:, None]
    flip = flip[:, None]
    u = torch.minimum(torch.clamp((dst + 0.5) * scale - 0.5, min=0.0), top)
    u = torch.where(flip, top - u, u) + crop0[:, None]
    lo = torch.floor(u)
    w_hi = u - lo
    hi = torch.clamp(lo + 1.0, max=out_size - 1.0)
    n = torch.minimum(torch.floor(dst * scale), top)
    n = torch.where(flip, top - n, n) + crop0[:, None]
    return lo.long(), hi.long(), w_hi, n.long()


def _take(x, dim, index):
    shape = list(x.shape)
    shape[dim] = index.shape[1]
    view = index[:, :, None, None] if dim == 1 else index[:, None, :, None]
    return torch.gather(x, dim, view.expand(shape))


def _lerp(x, dim, lo, hi, w_hi):
    w = w_hi[:, :, None, None] if dim == 1 else w_hi[:, None, :, None]
    return _take(x, dim, lo) * (1.0 - w) + _take(x, dim, hi) * w


def augment(rgb, depth, k, draws, aug: Dict):
    """(rgb, depth, K) of a batch after crop, flip and jitter; draws (B,
    6) float32 on the batch's device."""
    b, height, width = rgb.shape[0], rgb.shape[1], rgb.shape[2]
    h = torch.full((b,), float(height), dtype=torch.float32, device=rgb.device)
    w = torch.full_like(h, float(width))
    if aug["random_crop"]:
        ch = torch.floor(h * draws[:, 0])
        cw = torch.floor(w * draws[:, 0])
        ux = torch.floor(draws[:, 1] * (torch.clamp(w - cw, min=1.0) + 1.0))
        uy = torch.floor(draws[:, 2] * (torch.clamp(h - ch, min=1.0) + 1.0))
        cw, ch = torch.minimum(cw, w - ux), torch.minimum(ch, h - uy)
    else:
        ux = uy = torch.zeros_like(h)
        cw, ch = w, h
    flip = draws[:, 3] < aug["flip_probability"] if aug["horizontal_flip"] \
        else torch.zeros_like(h, dtype=torch.bool)
    if aug["color_jitter"]:
        rgb = torch.clamp(rgb * draws[:, 5, None, None, None]
                          + draws[:, 4, None, None, None] - 1.0, 0.0, 1.0)
    lo_w, hi_w, wt_w, nw = _axis(width, ux, cw, flip)
    lo_h, hi_h, wt_h, nh = _axis(height, uy, ch, torch.zeros_like(flip))
    rgb = _lerp(_lerp(rgb, 1, lo_h, hi_h, wt_h), 2, lo_w, hi_w, wt_w)
    depth = _take(_take(depth, 1, nh), 2, nw)
    fx, fy, cx, cy = k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]
    cx, cy = cx - ux, cy - uy
    cx = torch.where(flip, cw - cx - 1.0, cx)
    sx, sy = w / cw, h / ch
    k = k.clone()
    k[:, 0, 0], k[:, 1, 1] = fx * sx, fy * sy
    k[:, 0, 2], k[:, 1, 2] = cx * sx, cy * sy
    return rgb, depth, k


def batch(scenes: Dict[str, torch.Tensor], rows, draws, aug: Dict,
          quantized: bool) -> Dict[str, torch.Tensor]:
    """The feed's batch of scene ``rows`` (a LongTensor on the scenes'
    device), augmented on their ``draws``."""
    rgb, depth = stored(scenes["rgb"].index_select(0, rows),
                        scenes["depth"].index_select(0, rows), quantized)
    rgb, depth, k = augment(rgb, depth, scenes["k"].index_select(0, rows),
                            draws, aug)
    k4 = torch.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]], -1)
    return {"rgb": rgb, "depth": depth, "intrinsics": k, "k4": k4}
