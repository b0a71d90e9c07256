"""The four-term depth loss in plain PyTorch, float32, NHWC.

total = si * SILog + grad * gradient matching + smooth * edge-aware
smoothness + reproj * point reprojection, with the reference
repository's definitions: SILog (Eigen 2014, lambda 0.5) over the valid
pixels, log-depth gradient matching averaged over four 2^s average-pooled
scales (no mask), smoothness of the depth divided by its per-sample mean
weighted by exp(-|image gradient|), and the mean distance between the
back-projected point clouds over the valid pixels. Depths are clipped to
[1e-6, 1000] before logs. |x| has derivative +1 at 0 and a clip passes
half the gradient at a bound, as the configuration's framework defines
them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

EPS = 1e-6
CLAMP_MAX = 1000.0


def _abs(x):
    return torch.where(x >= 0, x, -x)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _log(x):
    return torch.log(_clip(x, EPS, CLAMP_MAX))


def _pool(x, f):
    if f <= 1:
        return x
    b, h, w, c = x.shape
    oh, ow = h // f, w // f
    x = x[:, :oh * f, :ow * f]
    return x.reshape(b, oh, f, ow, f, c).mean(dim=(2, 4))


def _grad_term(p, g):
    px, gx = p[:, :, 1:] - p[:, :, :-1], g[:, :, 1:] - g[:, :, :-1]
    py, gy = p[:, 1:] - p[:, :-1], g[:, 1:] - g[:, :-1]
    return _abs(px - gx).mean() + _abs(py - gy).mean()


def combined_loss(pred, gt, image, k, valid, weights: Dict[str, float],
                  lam: float = 0.5, scales: int = 4
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, components) for depth (B, H, W, 1), image (B, H, W, 3), K
    (B, 3, 3) and the valid mask (B, H, W, 1)."""
    m = valid.float()
    n = m.sum()
    d = (_log(pred) - _log(gt)) * m
    n1 = n.clamp_min(1.0)
    si = torch.where(n > 0, (d * d).sum() / n1
                     - lam * d.sum().square() / (n1 * n1), 0.0)

    grad = 0.0
    for s in range(scales):
        grad = grad + _grad_term(_log(_pool(pred, 2 ** s)),
                                 _log(_pool(gt, 2 ** s)))
    grad = grad / scales

    dn = pred / (pred.mean(dim=(1, 2), keepdim=True) + EPS)
    igx = _abs(image[:, :, 1:] - image[:, :, :-1]).mean(-1, keepdim=True)
    igy = _abs(image[:, 1:] - image[:, :-1]).mean(-1, keepdim=True)
    smooth = (_abs(dn[:, :, 1:] - dn[:, :, :-1]) * torch.exp(-igx)).mean() + \
        (_abs(dn[:, 1:] - dn[:, :-1]) * torch.exp(-igy)).mean()

    b, h, w, _ = pred.shape
    fx, fy = k[:, 0, 0, None, None, None], k[:, 1, 1, None, None, None]
    cx, cy = k[:, 0, 2, None, None, None], k[:, 1, 2, None, None, None]
    u = torch.arange(w, dtype=torch.float32, device=pred.device)[None, None, :, None]
    v = torch.arange(h, dtype=torch.float32, device=pred.device)[None, :, None, None]
    dz = pred - gt
    dx, dy = (u - cx) / (fx + EPS) * dz, (v - cy) / (fy + EPS) * dz
    err = torch.sqrt(dx * dx + dy * dy + dz * dz + EPS)
    reproj = torch.where(n > 0, (err * m).sum() / n1, 0.0)

    total = (weights["si"] * si + weights["grad"] * grad
             + weights["smooth"] * smooth + weights["reproj"] * reproj)
    return total, {"si_loss": si, "grad_loss": grad, "smooth_loss": smooth,
                   "reproj_loss": reproj, "total_loss": total}
