"""The two-pass affine warp in plain PyTorch, float32, differentiated by
autograd.

Output pixel (row i, col j) reads the source position ``px = A j + B i +
C``, ``py = D j + E i + F`` (pixels, torch's ``affine_grid`` convention,
``align_corners=False``). The warp resamples columns first, then rows:

  V[b,i,x,c]   = sum_y tent(g(x,i) - y) * img[b,y,x,c],  g = p x + q i + r
  out[b,i,j,c] = sum_x tent(h(j,i) - x) * V[b,i,x,c],    h = A j + B i + C
  tent(d) = max(1 - |d|, 0),  p = D / A_safe,  q = E - p B,  r = F - p C

with zeros outside the map. This is the function the PCL's warp computes
(the reference repository's ``two_pass_affine_warp``); under rotation it
differs from a bilinear ``grid_sample``, so the port is held to this one.
"""

from __future__ import annotations

import torch


def _coeffs(theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 6) rows [A, B, C, p, q, r] of a (B, 2, 3) theta."""
    t = theta.float()
    hf, wf = float(h), float(w)
    a = t[:, 0, 0]
    b = t[:, 0, 1] * wf / t.new_tensor(hf)
    c = (wf / 2.0) * (t[:, 0, 0] * (1.0 / wf - 1.0)
                      + t[:, 0, 1] * (1.0 / hf - 1.0) + t[:, 0, 2] + 1.0) - 0.5
    d = t[:, 1, 0] * hf / t.new_tensor(wf)
    e = t[:, 1, 1]
    f = (hf / 2.0) * (t[:, 1, 0] * (1.0 / wf - 1.0)
                      + t[:, 1, 1] * (1.0 / hf - 1.0) + t[:, 1, 2] + 1.0) - 0.5
    a_safe = torch.where(a.abs() < 1e-3,
                         torch.where(a < 0, -1e-3, 1e-3).to(a.dtype), a)
    p = d / a_safe
    return torch.stack([a, b, c, p, e - p * b, f - p * c], dim=-1)


def _taps(pos: torch.Tensor, size: int):
    """Indices and weights of the two taps of ``tent(pos - y)``; a tap
    outside [0, size - 1] weighs 0."""
    y0 = torch.floor(pos)
    y1 = y0 + 1.0
    w0 = (1.0 - (pos - y0).abs()).clamp_min(0.0)
    w1 = (1.0 - (pos - y1).abs()).clamp_min(0.0)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    w0 = torch.where((y0 >= 0.0) & (y0 <= size - 1.0), w0, zero)
    w1 = torch.where((y1 >= 0.0) & (y1 <= size - 1.0), w1, zero)
    i0 = y0.detach().clamp(0.0, size - 1.0).long()
    i1 = y1.detach().clamp(0.0, size - 1.0).long()
    return i0, i1, w0, w1


def two_pass_warp(img: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Warp NHWC ``img`` (B, H, W, C) by ``theta`` (B, 2, 3), zeros
    padding; float32 in, float32 out."""
    bsz, h, w, _ = img.shape
    dev = img.device
    co = _coeffs(theta, h, w)
    a, b, c, p, q, r = (co[:, k, None, None] for k in range(6))
    ii = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    bi = torch.arange(bsz, device=dev)[:, None, None]
    # pass V: for each (b, i, x), two source rows of column x
    y0, y1, w0, w1 = _taps(p * xs + q * ii + r, h)
    v = w0[..., None] * img[bi, y0, xs.long()] + \
        w1[..., None] * img[bi, y1, xs.long()]
    # pass H: for each (b, i, j), two columns of row i of V
    x0, x1, u0, u1 = _taps(a * xs + b * ii + c, w)
    ri = ii.long()
    return u0[..., None] * v[bi, ri, x0] + u1[..., None] * v[bi, ri, x1]
