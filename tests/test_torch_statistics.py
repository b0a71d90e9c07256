"""The port's model-comparison statistics and tables
(``cadepth_tpu_torch.metrics.statistical_tests`` and
``.experiment_comparison``, numpy only) against the JAX package's on
seeded inputs: the tests' statistics, p-values and effect sizes to 1e-12,
the bootstrap interval equal for the same seed, the reports and tables
equal as text, and the CSV round trip. No JAX computation runs."""

from __future__ import annotations

import numpy as np
import pytest

import torch_port_common  # noqa: F401  (one torch thread per process)
from cadepth_tpu.metrics import experiment_comparison as j_exp
from cadepth_tpu.metrics import statistical_tests as j_stats
from cadepth_tpu_torch.metrics import experiment_comparison as p_exp
from cadepth_tpu_torch.metrics import statistical_tests as p_stats

# (label, a, b) per-sample samples: a difference, no difference, ties and
# zero differences for the signed-rank test, two samples only, identical
PAIRS = {
    "shifted": lambda rng: (rng.normal(0.12, 0.03, 40),
                            rng.normal(0.10, 0.03, 40)),
    "same_law": lambda rng: (rng.normal(0.1, 0.02, 25),
                             rng.normal(0.1, 0.02, 25)),
    "ties": lambda rng: (np.round(rng.normal(1.0, 0.2, 30), 1),
                         np.round(rng.normal(1.0, 0.2, 30), 1)),
    "two": lambda rng: (rng.normal(0, 1, 2), rng.normal(0, 1, 2)),
    "identical": lambda rng: (np.full(10, 0.5), np.full(10, 0.5)),
}


def pair(label):
    return PAIRS[label](np.random.default_rng(sorted(PAIRS).index(label)))


def assert_result_equal(got, want):
    for field in ("statistic", "p_value", "effect_size"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-12, atol=1e-12, err_msg=field)
    assert got.significant == want.significant
    assert got.description == want.description


@pytest.mark.parametrize("label", sorted(PAIRS))
@pytest.mark.parametrize("test", ["paired_t_test", "wilcoxon_signed_rank"])
def test_paired_tests_match_jax(test, label):
    a, b = pair(label)
    assert_result_equal(getattr(p_stats, test)(a, b, 0.05),
                        getattr(j_stats, test)(a, b, 0.05))


@pytest.mark.parametrize("label", sorted(PAIRS))
def test_cohens_d_matches_jax(label):
    a, b = pair(label)
    np.testing.assert_allclose(p_stats.cohens_d(a, b), j_stats.cohens_d(a, b),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", [42, 7])
@pytest.mark.parametrize("confidence", [0.95, 0.8])
def test_bootstrap_interval_equals_jax(seed, confidence):
    values, _ = pair("shifted")
    got = p_stats.bootstrap_confidence_interval(values, confidence,
                                                seed=seed)
    assert got == j_stats.bootstrap_confidence_interval(values, confidence,
                                                        seed=seed)
    assert got[0] < values.mean() < got[1]
    assert p_stats.bootstrap_confidence_interval([]) == (0.0, 0.0)


def test_paired_t_test_refuses_unequal_samples():
    with pytest.raises(ValueError, match="equal-length"):
        p_stats.paired_t_test([1.0, 2.0], [1.0])


def per_sample(rng, n=30):
    return {"abs_rel": list(rng.normal(0.12, 0.02, n)),
            "rmse": list(rng.normal(0.5, 0.1, n)),
            "delta_1.25": list(rng.uniform(0.7, 0.9, n)),
            "only_here": list(rng.normal(0, 1, n))}


def test_compare_models_report_equals_jax():
    rng = np.random.default_rng(3)
    a, b = per_sample(rng), per_sample(rng)
    b.pop("only_here")
    lib = {"delta_1.25": False}
    want = j_stats.compare_models("run_a", a, "run_b", b, 0.05, lib)
    assert p_stats.compare_models("run_a", a, "run_b", b, 0.05, lib) == want
    assert "Metric: only_here" not in want and "Metric: rmse" in want


def results(rng):
    return [j_exp.ExperimentResult(
        name=f"model_{i}",
        metrics={m: float(rng.uniform(0.05, 0.95))
                 for m in j_exp.METRIC_COLUMNS[:5 + i % 3]},
        num_params=int(rng.integers(1e5, 3e7)),
        inference_ms=float(rng.uniform(1, 30)),
        notes="" if i % 2 else f"note {i}, quoted \"x\"") for i in range(4)]


def as_port(rs):
    return [p_exp.ExperimentResult(r.name, dict(r.metrics), r.num_params,
                                   r.inference_ms, r.notes) for r in rs]


@pytest.mark.parametrize("table", ["to_markdown_table", "to_latex_table",
                                   "to_csv"])
def test_tables_equal_jax(table):
    rs = results(np.random.default_rng(4))
    assert getattr(p_exp, table)(as_port(rs)) == getattr(j_exp, table)(rs)


@pytest.mark.parametrize("metric", ["abs_rel", "delta_1.25", "rmse"])
def test_ranking_ablation_and_report_equal_jax(metric):
    rs = results(np.random.default_rng(5))
    ps = as_port(rs)
    assert [r.name for r in p_exp.rank_results(ps, metric)] == \
        [r.name for r in j_exp.rank_results(rs, metric)]
    assert p_exp.best_result(ps, metric).name == \
        j_exp.best_result(rs, metric).name
    assert p_exp.ablation_analysis(ps, "model_0") == \
        j_exp.ablation_analysis(rs, "model_0")
    assert p_exp.full_report(ps, "model_1", metric) == \
        j_exp.full_report(rs, "model_1", metric)
    with pytest.raises(ValueError, match="Baseline"):
        p_exp.ablation_analysis(ps, "absent")
    assert p_exp.best_result([], metric) is None


def test_csv_round_trip():
    ps = as_port(results(np.random.default_rng(6)))
    text = p_exp.to_csv(ps)
    back = p_exp.from_csv(text)
    assert p_exp.to_csv(back) == text
    for r, s in zip(ps, back):
        assert (s.name, s.num_params, s.inference_ms, s.notes) == \
            (r.name, r.num_params, r.inference_ms, r.notes)
        # from_csv keeps the metrics the row has; to_csv wrote 0.0 for
        # the missing ones
        assert s.metrics == {m: r.metrics.get(m, 0.0)
                             for m in p_exp.METRIC_COLUMNS}
    assert [vars(x) for x in back] == [vars(x) for x in j_exp.from_csv(text)]
