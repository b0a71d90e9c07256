"""Monocular depth metrics (port of ``cadepth_tpu.metrics.depth_metrics``).

The nine metrics and three auxiliary values come from one fixed-shape
masked reduction. The mask is gt in (min_depth, max_depth), strict, and
an optional user mask; predictions are clamped to [min_depth, max_depth]
and gt is used as it is. The per-sample metrics, their average, the
running accumulator and the formatting are host helpers around it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

METRIC_NAMES = (
    "abs_rel",
    "sq_rel",
    "rmse",
    "rmse_log",
    "mae",
    "log10",
    "delta_1.25",
    "delta_1.25^2",
    "delta_1.25^3",
    "num_valid_pixels",
    "mean_pred_depth",
    "mean_gt_depth",
)


def compute_depth_metrics(pred: torch.Tensor, gt: torch.Tensor,
                          valid_mask: Optional[torch.Tensor] = None,
                          min_depth: float = 0.1,
                          max_depth: float = 10.0,
                          dp=None) -> Dict[str, torch.Tensor]:
    """Every metric over the valid pixels of a map of any leading shape,
    as float32 scalars; all zero when no pixel is valid. Under ``dp`` (a
    ``parallel.DataParallel``) the masked sums are all-reduced first, so
    every rank gets the metrics of the global batch."""
    pred = pred.float()
    gt = gt.float()
    mask = (gt > min_depth) & (gt < max_depth)
    if valid_mask is not None:
        mask = mask & valid_mask.bool()
    maskf = mask.float()

    one = torch.ones((), dtype=torch.float32, device=pred.device)
    # logs and ratios of pixels outside the mask are zeroed by maskf, but
    # NaN * 0 is NaN, so those pixels take a safe value first
    g = torch.where(mask, gt, one)
    p = torch.where(mask, pred.clamp(min_depth, max_depth), one)
    diff = p - g
    abs_diff = diff.abs()
    log_diff = torch.log(p) - torch.log(g)
    ratio = torch.maximum(p / g, g / p)
    terms = {
        "abs_rel": abs_diff / g,
        "sq_rel": diff * diff / g,
        "rmse": diff * diff,
        "rmse_log": log_diff * log_diff,
        "mae": abs_diff,
        # a tensor divisor: PyTorch's CUDA division by a Python float
        # multiplies by its reciprocal, which can differ by an ulp from
        # the division the CPU and JAX compute
        "log10": log_diff.abs() / g.new_tensor(math.log(10.0)),
        "delta_1.25": (ratio < 1.25).float(),
        "delta_1.25^2": (ratio < 1.25 ** 2).float(),
        "delta_1.25^3": (ratio < 1.25 ** 3).float(),
        "mean_pred_depth": p,
        "mean_gt_depth": g,
    }
    sums = {k: (v * maskf).sum() for k, v in terms.items()}
    n = maskf.sum()
    if dp is not None:
        total = dp.sum(torch.stack(list(sums.values()) + [n]))
        sums, n = dict(zip(sums, total[:-1].unbind())), total[-1]
    n_safe = n.clamp_min(1.0)
    means = {k: v / n_safe for k, v in sums.items()}
    for k in ("rmse", "rmse_log"):
        means[k] = torch.sqrt(means[k])
    means["num_valid_pixels"] = n
    zero = torch.zeros((), dtype=torch.float32, device=pred.device)
    return {k: torch.where(n > 0, means[k], zero) for k in METRIC_NAMES}


def compute_depth_metrics_per_sample(
    pred: torch.Tensor, gt: torch.Tensor,
    valid_mask: Optional[torch.Tensor] = None, min_depth: float = 0.1,
    max_depth: float = 10.0) -> Dict[str, torch.Tensor]:
    """The metrics of each sample of a batch: a dict of (B,) tensors, each
    sample reduced as :func:`compute_depth_metrics` reduces a map (JAX
    vmaps it)."""
    per = [compute_depth_metrics(
        pred[i], gt[i], None if valid_mask is None else valid_mask[i],
        min_depth, max_depth) for i in range(pred.shape[0])]
    return {k: torch.stack([m[k] for m in per]) for k in METRIC_NAMES}


def average_metrics(metrics_list: List[Dict[str, float]]) -> Dict[str, float]:
    """Arithmetic mean of a list of metric dicts (host-side)."""
    if not metrics_list:
        return {k: 0.0 for k in METRIC_NAMES}
    out: Dict[str, float] = {}
    for key in metrics_list[0]:
        out[key] = float(sum(float(m[key]) for m in metrics_list)
                         / len(metrics_list))
    return out


class MetricsAccumulator:
    """Running mean of metric dicts over batches."""

    def __init__(self) -> None:
        self._sums: Dict[str, float] = {}
        self._count = 0

    def update(self, metrics: Dict[str, float]) -> None:
        for key, value in metrics.items():
            self._sums[key] = self._sums.get(key, 0.0) + float(value)
        self._count += 1

    def average(self) -> Dict[str, float]:
        if self._count == 0:
            return {}
        return {k: v / self._count for k, v in self._sums.items()}

    def reset(self) -> None:
        self._sums.clear()
        self._count = 0

    @property
    def count(self) -> int:
        return self._count


def format_metrics(metrics: Dict[str, float]) -> str:
    """A metric dict as the reference's ``formatMetrics`` prints it."""
    lines = [
        "Error Metrics:",
        f"  AbsRel:  {float(metrics['abs_rel']):.4f}",
        f"  RMSE:    {float(metrics['rmse']):.4f}",
        f"  RMSElog: {float(metrics['rmse_log']):.4f}",
        f"  MAE:     {float(metrics['mae']):.4f}",
        "",
        "Accuracy Metrics (%):",
        f"  delta < 1.25:    {float(metrics['delta_1.25']) * 100.0:.4f}%",
        f"  delta < 1.25^2:  {float(metrics['delta_1.25^2']) * 100.0:.4f}%",
        f"  delta < 1.25^3:  {float(metrics['delta_1.25^3']) * 100.0:.4f}%",
        "",
        "Statistics:",
        f"  Valid pixels: {int(metrics['num_valid_pixels'])}",
        f"  Mean pred:    {float(metrics['mean_pred_depth']):.4f}m",
        f"  Mean GT:      {float(metrics['mean_gt_depth']):.4f}m",
    ]
    return "\n".join(lines)
