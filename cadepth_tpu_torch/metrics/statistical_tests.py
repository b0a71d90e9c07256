"""Statistical significance testing for model comparison.

A copy of ``cadepth_tpu.metrics.statistical_tests``, which
imports no JAX: the port keeps its own so that it never imports the
JAX package.

Port of `src/evaluation/statistical_tests.h`: paired t-test with
normal-approximation p-value (`:58-114,468-485`), Wilcoxon signed-rank
with normal approximation (`:128-215`), Cohen's d (`:231-248`),
bootstrap confidence intervals with 10k resamples (`:261-301`), and the
`compareModels` full-report generator (`:318-419`). Pure numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class TestResult:
    statistic: float
    p_value: float
    significant: bool
    effect_size: float = 0.0
    description: str = ""


def _normal_sf(z: float) -> float:
    """P(Z > z) for standard normal (the reference's erfc approximation)."""
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def paired_t_test(a: Sequence[float], b: Sequence[float],
                  alpha: float = 0.05) -> TestResult:
    """Two-sided paired t-test, p-value via normal approximation
    (`statistical_tests.h:58-114`)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape or a.size < 2:
        raise ValueError("paired_t_test needs two equal-length samples (n>=2)")
    d = a - b
    n = d.size
    mean = d.mean()
    sd = d.std(ddof=1)
    if sd == 0:
        t = 0.0 if mean == 0 else math.inf * np.sign(mean)
        p = 1.0 if mean == 0 else 0.0
    else:
        t = mean / (sd / math.sqrt(n))
        p = 2.0 * _normal_sf(abs(t))
    return TestResult(
        statistic=float(t), p_value=float(p), significant=p < alpha,
        effect_size=cohens_d(a, b),
        description=f"Paired t-test: t={t:.4f}, p={p:.4g}, n={n}")


def wilcoxon_signed_rank(a: Sequence[float], b: Sequence[float],
                         alpha: float = 0.05) -> TestResult:
    """Wilcoxon signed-rank with normal approximation
    (`statistical_tests.h:128-215`). Zero differences are dropped;
    ties share average ranks."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = a - b
    d = d[d != 0]
    n = d.size
    if n == 0:
        return TestResult(0.0, 1.0, False, 0.0, "Wilcoxon: all pairs tied")
    abs_d = np.abs(d)
    order = np.argsort(abs_d)
    ranks = np.empty(n, np.float64)
    ranks[order] = np.arange(1, n + 1, dtype=np.float64)
    # average ranks over ties
    for value in np.unique(abs_d):
        mask = abs_d == value
        if mask.sum() > 1:
            ranks[mask] = ranks[mask].mean()
    w_plus = ranks[d > 0].sum()
    w_minus = ranks[d < 0].sum()
    w = min(w_plus, w_minus)
    mean_w = n * (n + 1) / 4.0
    sd_w = math.sqrt(n * (n + 1) * (2 * n + 1) / 24.0)
    if sd_w == 0:
        z, p = 0.0, 1.0
    else:
        z = (w - mean_w) / sd_w
        p = 2.0 * _normal_sf(abs(z))
    p = min(p, 1.0)
    return TestResult(
        statistic=float(w), p_value=float(p), significant=p < alpha,
        effect_size=cohens_d(a, b),
        description=f"Wilcoxon signed-rank: W={w:.1f}, z={z:.4f}, p={p:.4g}, n={n}")


def cohens_d(a: Sequence[float], b: Sequence[float]) -> float:
    """Cohen's d with pooled standard deviation (`statistical_tests.h:231-248`)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    va = a.var(ddof=1) if a.size > 1 else 0.0
    vb = b.var(ddof=1) if b.size > 1 else 0.0
    pooled = math.sqrt((va + vb) / 2.0)
    if pooled == 0:
        return 0.0
    return float((a.mean() - b.mean()) / pooled)


def bootstrap_confidence_interval(
    values: Sequence[float],
    confidence: float = 0.95,
    num_resamples: int = 10_000,
    seed: int = 42,
) -> Tuple[float, float]:
    """Percentile bootstrap CI of the mean, 10k resamples
    (`statistical_tests.h:261-301`)."""
    values = np.asarray(values, np.float64)
    if values.size == 0:
        return (0.0, 0.0)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, values.size, size=(num_resamples, values.size))
    means = values[idx].mean(axis=1)
    lo = (1.0 - confidence) / 2.0
    return (float(np.quantile(means, lo)),
            float(np.quantile(means, 1.0 - lo)))


def compare_models(
    name_a: str,
    metrics_a: Dict[str, List[float]],
    name_b: str,
    metrics_b: Dict[str, List[float]],
    alpha: float = 0.05,
    lower_is_better: Optional[Dict[str, bool]] = None,
) -> str:
    """Full comparison report over shared per-sample metric lists
    (`StatisticalTester::compareModels`, `statistical_tests.h:318-419`)."""
    lower_is_better = lower_is_better or {}
    lines = [
        "=" * 60,
        f"Statistical comparison: {name_a} vs {name_b}",
        "=" * 60,
    ]
    for metric in sorted(set(metrics_a) & set(metrics_b)):
        a = np.asarray(metrics_a[metric], np.float64)
        b = np.asarray(metrics_b[metric], np.float64)
        if a.size != b.size or a.size < 2:
            continue
        t = paired_t_test(a, b, alpha)
        w = wilcoxon_signed_rank(a, b, alpha)
        ci_a = bootstrap_confidence_interval(a)
        ci_b = bootstrap_confidence_interval(b)
        lib = lower_is_better.get(metric, True)
        better = name_a if ((a.mean() < b.mean()) == lib) else name_b
        lines += [
            "",
            f"Metric: {metric}",
            f"  {name_a}: mean={a.mean():.4f} CI95=[{ci_a[0]:.4f}, {ci_a[1]:.4f}]",
            f"  {name_b}: mean={b.mean():.4f} CI95=[{ci_b[0]:.4f}, {ci_b[1]:.4f}]",
            f"  {t.description}",
            f"  {w.description}",
            f"  Cohen's d: {t.effect_size:.4f}",
            f"  Better: {better}"
            + (" (statistically significant)" if t.significant else
               " (not significant)"),
        ]
    return "\n".join(lines)
