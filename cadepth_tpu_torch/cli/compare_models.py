"""Cross-experiment comparison with statistical significance (the twin
of ``cli/compare_models.py``):

    python -m cadepth_tpu_torch.cli.compare_models results_a/ results_b/ \
        [more/ ...] [--scan <root>] [--baseline <name>] \
        [--output report.md] [--latex]

Each input directory is an evaluate CLI's output (per_sample_metrics.csv,
summary_metrics.csv, report.txt), the port's or the JAX package's: both
write the same files. Two directories also get the paired t-test, the
Wilcoxon signed-rank test and bootstrap confidence intervals on their
shared per-sample metrics (``metrics/statistical_tests.py``); the tables
come from ``metrics/experiment_comparison.py``.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path


def load_run(run_dir: Path):
    per_sample_path = run_dir / "per_sample_metrics.csv"
    if not per_sample_path.exists():
        raise FileNotFoundError(f"{per_sample_path} not found "
                                "(is this an evaluate.py output dir?)")
    per_sample: dict = {}
    with open(per_sample_path) as f:
        for row in csv.DictReader(f):
            for key, value in row.items():
                if key == "sample":
                    continue
                per_sample.setdefault(key, []).append(float(value))
    name = run_dir.name
    return name, per_sample


def scan_runs(root: Path):
    """Find every evaluate.py output dir under ``root`` (the reference's
    compare_models.sh:1-457 scans its results tree the same way)."""
    found = sorted({p.parent for p in root.rglob("per_sample_metrics.csv")})
    if not found:
        raise FileNotFoundError(
            f"no per_sample_metrics.csv found anywhere under {root}")
    return found


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Compare evaluated models")
    p.add_argument("runs", nargs="*", help="evaluate.py output directories")
    p.add_argument("--scan", default="",
                   help="recursively discover evaluation runs under this "
                        "directory instead of listing them")
    p.add_argument("--baseline", default="",
                   help="run name for ablation percentages")
    p.add_argument("--metric", default="abs_rel")
    p.add_argument("--alpha", type=float, default=0.05)
    p.add_argument("--output", default="", help="write the report to a file "
                   "(or into <dir>/comparison_report.md if a directory)")
    p.add_argument("--latex", action="store_true")
    args = p.parse_args(argv)

    if args.scan:
        discovered = scan_runs(Path(args.scan))
        print(f"Discovered {len(discovered)} run(s) under {args.scan}:")
        for d in discovered:
            print(f"  {d}")
        args.runs = [str(d) for d in discovered] + list(args.runs)
    if len(args.runs) < 1:
        p.error("no runs given (pass directories or --scan <root>)")

    from cadepth_tpu_torch.metrics.experiment_comparison import (
        ExperimentResult,
        full_report,
        to_latex_table,
    )
    from cadepth_tpu_torch.metrics.statistical_tests import compare_models

    runs = [load_run(Path(r)) for r in args.runs]
    results = [
        ExperimentResult(
            name=name,
            metrics={k: sum(v) / len(v) for k, v in per_sample.items() if v},
        )
        for name, per_sample in runs
    ]

    parts = [full_report(results,
                         baseline_name=args.baseline or None,
                         metric=args.metric)]
    if len(runs) == 2:
        (name_a, ps_a), (name_b, ps_b) = runs
        parts.append("")
        parts.append(compare_models(name_a, ps_a, name_b, ps_b,
                                    alpha=args.alpha))
    if args.latex:
        parts.append("")
        parts.append(to_latex_table(results))

    report = "\n".join(parts)
    print(report)
    if args.output:
        out = Path(args.output)
        if out.is_dir() or not out.suffix:
            out.mkdir(parents=True, exist_ok=True)
            out = out / "comparison_report.md"
        out.write_text(report)
        print(f"\nReport written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
