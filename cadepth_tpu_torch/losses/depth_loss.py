"""Depth losses (port of ``cadepth_tpu.losses.depth_loss``), NHWC, float32.

Shapes: pred/gt depth (B, H, W, 1); image (B, H, W, 3); intrinsics
(B, 3, 3) or (3, 3); masks are boolean, the shape of the depth. Masked
reductions are fixed-shape ``where``-sums, and the combined loss returns
its components from one evaluation, as in the JAX package.

Gradients follow JAX's conventions at the kinks, where torch's own
differ: ``abs`` has derivative +1 at 0 (torch: 0), and a clip passes half
the gradient on a bound (torch's ``clamp``: all of it). Depth
differences can be exactly 0 (equal neighbours, gt zeros clamped to the
same floor), so :func:`_abs` and :func:`_clip` carry JAX's rules.

Under a data-parallel group (:class:`CombinedDepthLoss`'s ``dp``, a
``parallel.DataParallel``) each term is the single process's over the
global batch, as under JAX's mesh: the masked sums of SILog and of the
reprojection loss go into one all-reduce before their ratios (SILog's
``lam * (sum d)^2 / n^2`` is not linear in them, and a rank with fewer
valid pixels weighs less), beside the plain means of the
gradient-matching and smoothness terms, which are averaged over the
ranks (they hold as many pixels each). Every rank then holds the same
total loss. The all-reduce's backward sums the gradients over the ranks,
so each rank back-propagates ``loss / W`` and the parameter gradients are
summed over the ranks (``training/train_state.py``): that is the
gradient of the global loss. Without ``dp`` the arithmetic is the single
process's.

Under spatial parallelism (``dp.space``) each rank holds a band of rows,
and a band's plain mean is not the image's: the H - 1 row differences
do not split evenly over the bands. So the gradient-matching and
smoothness terms become sums, each divided by the global batch's count
before the all-reduce (:func:`_banded_terms`). A row difference across
two bands is counted once, by the lower band, from one halo row of the
band above; the smoothness term's per-sample mean depth is a sum over
the space row; the pooled scales of the gradient matching follow the
model's band rule (a band the pool factor does not divide is gathered,
and its whole map counted by the row's first rank alone). SILog's and
the reprojection loss's sums are sums already; the reprojection takes
the band's image rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from cadepth_tpu_torch.ops.resize import avg_pool2d

_CLAMP_MAX = 1000.0


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with derivative +1 at 0, as ``jnp.abs``."""
    return torch.where(x >= 0, x, -x)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: max then min, each passing half the gradient on a tie."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _masked_sums(values: torch.Tensor, mask: torch.Tensor
                 ) -> List[torch.Tensor]:
    """(sum of ``values`` over ``mask``, the mask's count)."""
    mask = mask.to(values.dtype)
    return [(values * mask).sum(), mask.sum()]


def _ratio(total: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``total / n``; 0 if ``n`` is 0 (an empty mask)."""
    return torch.where(n > 0, total / n.clamp_min(1.0), 0.0)


def _si_sums(pred: torch.Tensor, gt: torch.Tensor,
             valid_mask: Optional[torch.Tensor], eps: float
             ) -> List[torch.Tensor]:
    """SILog's (sum d^2, sum d, n) over the mask."""
    pred = pred.float()
    gt = gt.float()
    mask = (gt > eps) if valid_mask is None else valid_mask
    maskf = mask.float()
    d = torch.log(_clip(pred, eps, _CLAMP_MAX)) - \
        torch.log(_clip(gt, eps, _CLAMP_MAX))
    d = d * maskf
    return [(d * d).sum(), d.sum(), maskf.sum()]


def _si_from_sums(sum_sq: torch.Tensor, sum_d: torch.Tensor,
                  n: torch.Tensor, lam: float) -> torch.Tensor:
    n_safe = n.clamp_min(1.0)
    term1 = sum_sq / n_safe
    term2 = lam * sum_d.square() / (n_safe * n_safe)
    return torch.where(n > 0, term1 - term2, 0.0)


def scale_invariant_loss(pred: torch.Tensor, gt: torch.Tensor,
                         valid_mask: Optional[torch.Tensor] = None,
                         lam: float = 0.5, eps: float = 1e-6) -> torch.Tensor:
    """Eigen'14 SILog loss: mean(d^2) - lam * (sum d)^2 / n^2,
    d = log p - log g over the mask (default gt > eps), depths clipped to
    [eps, 1000]; 0 on an empty mask."""
    return _si_from_sums(*_si_sums(pred, gt, valid_mask, eps), lam)


def _gradient_loss_single_scale(pred_log: torch.Tensor,
                                gt_log: torch.Tensor) -> torch.Tensor:
    """L1 between forward-difference gradients, averaged over all pixels
    (no mask: the reference declares one and never applies it)."""
    pgx = pred_log[..., :, 1:, :] - pred_log[..., :, :-1, :]
    ggx = gt_log[..., :, 1:, :] - gt_log[..., :, :-1, :]
    pgy = pred_log[..., 1:, :, :] - pred_log[..., :-1, :, :]
    ggy = gt_log[..., 1:, :, :] - gt_log[..., :-1, :, :]
    return _abs(pgx - ggx).mean() + _abs(pgy - ggy).mean()


def gradient_matching_loss(pred: torch.Tensor, gt: torch.Tensor,
                           valid_mask: Optional[torch.Tensor] = None,
                           num_scales: int = 4,
                           eps: float = 1e-6) -> torch.Tensor:
    """MiDaS multi-scale gradient matching in log-depth space: scale s
    average-pooled by 2^s, log-clipped to [eps, 1000], averaged over
    scales. ``valid_mask`` is accepted and unused, as in the reference."""
    del valid_mask
    pred = pred.float()
    gt = gt.float()
    total = 0.0
    for scale in range(num_scales):
        if scale == 0:
            p, g = pred, gt
        else:
            p = avg_pool2d(pred, 2 ** scale)
            g = avg_pool2d(gt, 2 ** scale)
        p = torch.log(_clip(p, eps, _CLAMP_MAX))
        g = torch.log(_clip(g, eps, _CLAMP_MAX))
        total = total + _gradient_loss_single_scale(p, g)
    return total / num_scales


def smoothness_loss(pred: torch.Tensor, image: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """Edge-aware smoothness: mean |d dn| * exp(-|d I|), dn the depth
    divided by its per-sample mean, image gradients averaged over RGB."""
    pred = pred.float()
    image = image.float()
    dn = pred / (pred.mean(dim=(-3, -2), keepdim=True) + eps)
    dgx = _abs(dn[..., :, 1:, :] - dn[..., :, :-1, :])
    dgy = _abs(dn[..., 1:, :, :] - dn[..., :-1, :, :])
    igx = _abs(image[..., :, 1:, :] - image[..., :, :-1, :]).mean(
        -1, keepdim=True)
    igy = _abs(image[..., 1:, :, :] - image[..., :-1, :, :]).mean(
        -1, keepdim=True)
    return (dgx * torch.exp(-igx)).mean() + (dgy * torch.exp(-igy)).mean()


def _reproj_sums(pred: torch.Tensor, gt: torch.Tensor,
                 intrinsics: torch.Tensor, valid_mask: Optional[torch.Tensor],
                 eps: float, row0: int = 0) -> List[torch.Tensor]:
    """The reprojection loss's (sum of point errors, count) over the
    mask; the maps' first row is the image's row ``row0``."""
    pred = pred.float()
    gt = gt.float()
    b, h, w, _ = pred.shape
    if intrinsics.dim() == 2:
        intrinsics = intrinsics.expand(b, 3, 3)
    k = intrinsics.float()
    fx = k[:, 0, 0][:, None, None, None]
    fy = k[:, 1, 1][:, None, None, None]
    cx = k[:, 0, 2][:, None, None, None]
    cy = k[:, 1, 2][:, None, None, None]
    grid_x = torch.arange(w, dtype=torch.float32,
                          device=pred.device)[None, None, :, None]
    grid_y = torch.arange(row0, row0 + h, dtype=torch.float32,
                          device=pred.device)[None, :, None, None]
    xs = (grid_x - cx) / (fx + eps)
    ys = (grid_y - cy) / (fy + eps)
    diff_x = xs * (pred - gt)
    diff_y = ys * (pred - gt)
    diff_z = pred - gt
    point_error = torch.sqrt(diff_x * diff_x + diff_y * diff_y
                             + diff_z * diff_z + eps)
    mask = (gt > eps) if valid_mask is None else valid_mask
    return _masked_sums(point_error, mask)


def reprojection_loss(pred: torch.Tensor, gt: torch.Tensor,
                      intrinsics: torch.Tensor,
                      valid_mask: Optional[torch.Tensor] = None,
                      eps: float = 1e-6) -> torch.Tensor:
    """Mean L2 distance between the point clouds of pred and gt, both
    back-projected through K (per sample, or one K for the batch), with
    sqrt(diff^2 + eps), over the mask (default gt > eps); 0 on an empty
    mask."""
    return _ratio(*_reproj_sums(pred, gt, intrinsics, valid_mask, eps))


def reprojection_loss_photometric(pred: torch.Tensor, gt: torch.Tensor,
                                  intrinsics: torch.Tensor,
                                  source_image: torch.Tensor,
                                  target_image: torch.Tensor) -> torch.Tensor:
    """Photometric reprojection stub: 0, as the reference's
    ``forwardPhotometric``."""
    del gt, intrinsics, source_image, target_image
    return torch.zeros((), dtype=torch.float32, device=pred.device)


def _row_diffs(x: torch.Tensor, space) -> torch.Tensor:
    """The row differences ``x[i] - x[i - 1]`` of a band (B, h, W, C) of
    the image, i over its rows with a row above in the image: the first
    takes the halo row of the band above, and the image's first row has
    none. Every rank of the row calls it (the halo is a collective)."""
    x = space.halo(x, 1, 1)[:, int(space.rank == 0):-1]
    return x[:, 1:] - x[:, :-1]


def _banded_terms(pred: torch.Tensor, gt: torch.Tensor, image: torch.Tensor,
                  space, data_rows: int, num_scales: int, eps: float
                  ) -> List[torch.Tensor]:
    """This rank's parts of the gradient-matching and smoothness terms
    on bands: each of their sums over its band divided by the global
    batch's count (``data_rows`` rows of the local batch), so the sums over
    all ranks are the terms."""
    pred = pred.float()
    gt = gt.float()
    image = image.float()
    bsz, h, w, _ = pred.shape
    batch = bsz * data_rows
    one = pred.new_ones(())

    grad = pred.new_zeros(())
    for scale in range(num_scales):
        f = 2 ** scale
        p, g, banded = pred, gt, True
        if h % f:
            p, g, banded = space.gather(p, 1), space.gather(g, 1), False
        p = torch.log(_clip(avg_pool2d(p, f), eps, _CLAMP_MAX))
        g = torch.log(_clip(avg_pool2d(g, f), eps, _CLAMP_MAX))
        rows = p.shape[1] * (space.size if banded else 1)
        cols = p.shape[2]
        x_sum = _abs((p[:, :, 1:] - p[:, :, :-1])
                     - (g[:, :, 1:] - g[:, :, :-1])).sum()
        if banded:
            y_sum = _abs(_row_diffs(p, space) - _row_diffs(g, space)).sum()
        else:
            y_sum = _abs((p[:, 1:] - p[:, :-1]) - (g[:, 1:] - g[:, :-1])).sum()
        part = (x_sum / one.new_tensor(float(batch * rows * (cols - 1)))
                + y_sum / one.new_tensor(float(batch * (rows - 1) * cols)))
        if not banded and space.rank:
            part = part * 0.0     # the row's first rank counts a whole map
        grad = grad + part
    grad = grad / one.new_tensor(float(num_scales))

    mean = space.sum(pred.sum(dim=(-3, -2), keepdim=True)) / \
        one.new_tensor(float(h * space.size * w))
    dn = pred / (mean + eps)
    dgx = _abs(dn[:, :, 1:] - dn[:, :, :-1])
    igx = _abs(image[:, :, 1:] - image[:, :, :-1]).mean(-1, keepdim=True)
    dgy = _abs(_row_diffs(dn, space))
    igy = _abs(_row_diffs(image, space)).mean(-1, keepdim=True)
    rows = h * space.size
    smooth = ((dgx * torch.exp(-igx)).sum()
              / one.new_tensor(float(batch * rows * (w - 1)))
              + (dgy * torch.exp(-igy)).sum()
              / one.new_tensor(float(batch * (rows - 1) * w)))
    return [grad, smooth]


@dataclasses.dataclass(frozen=True)
class CombinedDepthLoss:
    """Weighted sum of the four depth loss terms, with every component
    from the same evaluation (defaults 1.0 / 0.1 / 0.001 / 0.01), over the
    global batch of ``dp`` (a ``parallel.DataParallel``) when one is
    given."""

    si_weight: float = 1.0
    grad_weight: float = 0.1
    smooth_weight: float = 0.001
    reproj_weight: float = 0.01
    si_lambda: float = 0.5
    grad_num_scales: int = 4
    eps: float = 1e-6
    dp: Optional[object] = None

    def __call__(self, pred: torch.Tensor, gt: torch.Tensor,
                 image: torch.Tensor,
                 intrinsics: Optional[torch.Tensor] = None,
                 valid_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total_loss, components). Without ``intrinsics`` there is no
        reprojection term."""
        space = None if self.dp is None else self.dp.space
        if space is None:
            row0 = 0
            sums = _si_sums(pred, gt, valid_mask, self.eps) + [
                gradient_matching_loss(pred, gt, valid_mask,
                                       self.grad_num_scales, self.eps),
                smoothness_loss(pred, image, self.eps)]
        else:
            row0 = space.row0(pred.shape[1])
            sums = _si_sums(pred, gt, valid_mask, self.eps) + _banded_terms(
                pred, gt, image, space, self.dp.data_size,
                self.grad_num_scales, self.eps)
        if intrinsics is not None:
            sums += _reproj_sums(pred, gt, intrinsics, valid_mask, self.eps,
                                 row0)
        if self.dp is not None:
            # every term's sums in one all-reduce
            sums = list(self.dp.sum(torch.stack(sums)).unbind())
            if space is None:
                # the plain means averaged (on bands their parts are sums)
                ranks = torch.full((), float(self.dp.world_size),
                                   dtype=sums[3].dtype, device=sums[3].device)
                sums[3], sums[4] = sums[3] / ranks, sums[4] / ranks
        si = _si_from_sums(*sums[:3], self.si_lambda)
        grad, smooth = sums[3], sums[4]
        components = {"si_loss": si, "grad_loss": grad,
                      "smooth_loss": smooth}
        total = (self.si_weight * si + self.grad_weight * grad
                 + self.smooth_weight * smooth)
        if intrinsics is not None:
            reproj = _ratio(*sums[5:])
            components["reproj_loss"] = reproj
            total = total + self.reproj_weight * reproj
        components["total_loss"] = total
        return total, components
