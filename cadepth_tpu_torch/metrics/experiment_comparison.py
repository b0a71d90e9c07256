"""Experiment result aggregation: tables, ablations, rankings, reports.

A copy of ``cadepth_tpu.metrics.experiment_comparison``, which
imports no JAX: the port keeps its own so that it never imports the
JAX package.

Port of `src/evaluation/experiment_comparison.h`: `ExperimentResult`
records (`:20-33`), LaTeX (`:77-117`) and Markdown (`:122-153`) tables,
ablation analysis vs a baseline with improvement percentages
(`:160-203,379-390`), CSV import/export (`:53-70,208-240`),
ranking/best-model selection (`:245-282`), and the full text report
(`:287-320`).
"""

from __future__ import annotations

import csv
import dataclasses
import io
from typing import Dict, List, Optional

METRIC_COLUMNS = ("abs_rel", "sq_rel", "rmse", "rmse_log",
                  "delta_1.25", "delta_1.25^2", "delta_1.25^3")
LOWER_IS_BETTER = {
    "abs_rel": True, "sq_rel": True, "rmse": True, "rmse_log": True,
    "mae": True, "log10": True,
    "delta_1.25": False, "delta_1.25^2": False, "delta_1.25^3": False,
}


@dataclasses.dataclass
class ExperimentResult:
    name: str
    metrics: Dict[str, float]
    num_params: int = 0
    inference_ms: float = 0.0
    notes: str = ""


def to_markdown_table(results: List[ExperimentResult]) -> str:
    """Markdown comparison table (`experiment_comparison.h:122-153`)."""
    header = "| Model | " + " | ".join(METRIC_COLUMNS) + " | Params | ms/img |"
    sep = "|" + "---|" * (len(METRIC_COLUMNS) + 3)
    rows = [header, sep]
    for r in results:
        cells = [r.name]
        cells += [f"{r.metrics.get(m, 0.0):.4f}" for m in METRIC_COLUMNS]
        cells += [f"{r.num_params:,}", f"{r.inference_ms:.2f}"]
        rows.append("| " + " | ".join(cells) + " |")
    return "\n".join(rows)


def to_latex_table(results: List[ExperimentResult],
                   caption: str = "Model comparison on SUN RGB-D") -> str:
    """LaTeX table (`experiment_comparison.h:77-117`)."""
    cols = "l" + "c" * (len(METRIC_COLUMNS) + 2)
    lines = [
        r"\begin{table}[t]",
        r"\centering",
        rf"\caption{{{caption}}}",
        rf"\begin{{tabular}}{{{cols}}}",
        r"\toprule",
        "Model & " + " & ".join(
            m.replace("_", r"\_").replace("^", r"$^$") for m in METRIC_COLUMNS)
        + r" & Params & ms \\",
        r"\midrule",
    ]
    for r in results:
        cells = [r.name.replace("_", r"\_")]
        cells += [f"{r.metrics.get(m, 0.0):.4f}" for m in METRIC_COLUMNS]
        cells += [f"{r.num_params / 1e6:.1f}M", f"{r.inference_ms:.2f}"]
        lines.append(" & ".join(cells) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}", r"\end{table}"]
    return "\n".join(lines)


def ablation_analysis(results: List[ExperimentResult],
                      baseline_name: str) -> str:
    """Improvement % of every experiment vs the named baseline
    (`experiment_comparison.h:160-203,379-390`)."""
    baseline = next((r for r in results if r.name == baseline_name), None)
    if baseline is None:
        raise ValueError(f"Baseline '{baseline_name}' not in results")
    lines = [f"Ablation analysis vs baseline '{baseline_name}':", ""]
    for r in results:
        if r.name == baseline_name:
            continue
        lines.append(f"{r.name}:")
        for metric in METRIC_COLUMNS:
            base = baseline.metrics.get(metric)
            val = r.metrics.get(metric)
            if base is None or val is None or base == 0:
                continue
            change = (val - base) / abs(base) * 100.0
            improved = (change < 0) == LOWER_IS_BETTER.get(metric, True)
            arrow = "improved" if improved else "regressed"
            lines.append(f"  {metric}: {base:.4f} -> {val:.4f} "
                         f"({change:+.2f}%, {arrow})")
        lines.append("")
    return "\n".join(lines)


def rank_results(results: List[ExperimentResult],
                 metric: str = "abs_rel") -> List[ExperimentResult]:
    """Sort best-first by a metric (`experiment_comparison.h:245-282`)."""
    reverse = not LOWER_IS_BETTER.get(metric, True)
    return sorted(results, key=lambda r: r.metrics.get(metric, float("inf")),
                  reverse=reverse)


def best_result(results: List[ExperimentResult],
                metric: str = "abs_rel") -> Optional[ExperimentResult]:
    ranked = rank_results(results, metric)
    return ranked[0] if ranked else None


def to_csv(results: List[ExperimentResult]) -> str:
    """CSV export (`experiment_comparison.h:208-240`)."""
    buf = io.StringIO()
    writer = csv.writer(buf)
    writer.writerow(["name"] + list(METRIC_COLUMNS) + ["num_params",
                                                       "inference_ms", "notes"])
    for r in results:
        writer.writerow([r.name]
                        + [r.metrics.get(m, 0.0) for m in METRIC_COLUMNS]
                        + [r.num_params, r.inference_ms, r.notes])
    return buf.getvalue()


def from_csv(text: str) -> List[ExperimentResult]:
    """CSV import (`experiment_comparison.h:53-70`)."""
    reader = csv.DictReader(io.StringIO(text))
    results = []
    for row in reader:
        metrics = {m: float(row[m]) for m in METRIC_COLUMNS if row.get(m)}
        results.append(ExperimentResult(
            name=row["name"], metrics=metrics,
            num_params=int(float(row.get("num_params", 0) or 0)),
            inference_ms=float(row.get("inference_ms", 0) or 0),
            notes=row.get("notes", "")))
    return results


def full_report(results: List[ExperimentResult],
                baseline_name: Optional[str] = None,
                metric: str = "abs_rel") -> str:
    """Markdown table + ranking + optional ablation
    (`experiment_comparison.h:287-320`)."""
    parts = ["# Experiment comparison report", "",
             to_markdown_table(rank_results(results, metric)), ""]
    best = best_result(results, metric)
    if best is not None:
        parts.append(f"**Best model by {metric}: {best.name} "
                     f"({best.metrics.get(metric, 0.0):.4f})**")
        parts.append("")
    if baseline_name is not None:
        parts.append(ablation_analysis(results, baseline_name))
    return "\n".join(parts)
