"""The port's depth-metric host helpers and ``ModelEvaluator`` against the
JAX package's: per-sample metrics, their average, the running
accumulator, the formatted text; then a whole evaluation of a small
geometry-aware model (f=4, 32x32, f32) with the same converted weights
on the synthetic fixture: per-sample metrics to 1e-5, and the CSVs and
the report with the same rows and keys."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import init_random
from cadepth_tpu import config as jax_config
from cadepth_tpu.data import sunrgbd as j_sunrgbd
from cadepth_tpu.data import synthetic as j_synthetic
from cadepth_tpu.evaluation import evaluator as j_eval
from cadepth_tpu.metrics import depth_metrics as j_metrics
from cadepth_tpu.training import train_state as jax_ts
from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.data import sunrgbd as p_sunrgbd
from cadepth_tpu_torch.evaluation import evaluator as p_eval
from cadepth_tpu_torch.metrics import depth_metrics as p_metrics
from cadepth_tpu_torch.training import train_state as ts


def _maps(seed: int, shape=(3, 20, 24, 1)):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.05, 12.0, shape).astype(np.float32)
    gt = rng.uniform(0.05, 12.0, shape).astype(np.float32)
    gt[rng.uniform(0, 1, shape) < 0.15] = 0.0
    return pred, gt


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bounds", [(0.1, 10.0), (0.5, 6.0)])
def test_per_sample_metrics(masked, bounds):
    """Each sample's 12 metrics at rtol 1e-5 (f32 sums over its pixels in
    another order); the pixel counts exactly; a sample with no valid
    pixel gives zeros on both sides."""
    pred, gt = _maps(1)
    gt[2] = 0.0  # no valid pixel
    mask = np.random.default_rng(2).uniform(0, 1, gt.shape) < 0.7 \
        if masked else None
    want = j_metrics.compute_depth_metrics_per_sample(
        jnp.asarray(pred), jnp.asarray(gt),
        None if mask is None else jnp.asarray(mask), *bounds)
    got = p_metrics.compute_depth_metrics_per_sample(
        torch.from_numpy(pred), torch.from_numpy(gt),
        None if mask is None else torch.from_numpy(mask), *bounds)
    assert list(got) == list(p_metrics.METRIC_NAMES) == \
        list(j_metrics.METRIC_NAMES)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape == (3,) and g.dtype == w.dtype
        if k == "num_valid_pixels":
            assert np.array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    assert all(float(got[k][2]) == 0.0 for k in got)


def test_average_accumulator_and_format():
    pred, gt = _maps(4)
    rows = []
    for i in range(3):
        m = j_metrics.compute_depth_metrics(jnp.asarray(pred[i]),
                                            jnp.asarray(gt[i]))
        rows.append({k: float(v) for k, v in m.items()})
    assert p_metrics.average_metrics(rows) == \
        j_metrics.average_metrics(rows)
    assert p_metrics.average_metrics([]) == j_metrics.average_metrics([])
    ja, pa = j_metrics.MetricsAccumulator(), p_metrics.MetricsAccumulator()
    assert pa.average() == ja.average() == {}
    for r in rows:
        ja.update(r)
        pa.update({k: torch.tensor(v) for k, v in r.items()})
    assert pa.count == ja.count == 3
    assert pa.average() == ja.average()
    pa.reset()
    assert pa.count == 0 and pa.average() == {}
    assert p_metrics.format_metrics(rows[0]) == \
        j_metrics.format_metrics(rows[0])


RAW = {"model": {"architecture": "geometry_aware", "init_features": 4},
       "data": {"input_height": 32, "input_width": 32,
                "compute_rays": True},
       "training": {"use_amp": False}}


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """Both evaluators over the same 12 fixture samples at batch 4, the
    port's model holding the JAX variables."""
    root = tmp_path_factory.mktemp("torch_eval_fixture")
    manifest = j_synthetic.generate_synthetic_dataset(
        str(root), images_per_sensor=3, seed=6)
    kw = dict(split="test", target_height=32, target_width=32,
              compute_rays=True, rays_on_device=True)
    jl = j_sunrgbd.SunRGBDLoader(f"{root}/sunrgbd", manifest, **kw)
    pl = p_sunrgbd.SunRGBDLoader(f"{root}/sunrgbd", manifest, **kw)
    jcfg = jax_config.config_from_dict(RAW)
    pcfg = port_config.config_from_dict(RAW)
    jm, _ = jax_ts.build_model_and_loss(jcfg)
    sample = jl.get_batch(range(2))
    rays = j_sunrgbd.SunRGBDLoader._compute_rays(sample["intrinsics"][0],
                                                 32, 32)[None]
    params, stats = init_random(jm, np.random.default_rng(0),
                                jnp.asarray(sample["rgb"][:1]),
                                jnp.asarray(rays),
                                jnp.asarray(sample["k4"][:1]))
    state = jax_ts.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=())
    pm, _ = ts.build_model_and_loss(pcfg, device="cpu")
    pm.load_state_dict(convert.to_torch(params, stats))
    ecfg = dict(batch_size=4, warmup_iterations=1)
    jr = j_eval.ModelEvaluator(jcfg, jm, state, j_eval.EvaluationConfig(
        **ecfg)).evaluate(jl)
    pr = p_eval.ModelEvaluator(pcfg, pm, p_eval.EvaluationConfig(
        **ecfg)).evaluate(pl)
    return jr, pr


def test_evaluator_per_sample_metrics_match(evaluated):
    jr, pr = evaluated
    assert pr.num_samples == jr.num_samples == 12
    assert pr.num_params == jr.num_params
    assert pr.model_size_mb == jr.model_size_mb
    for a, b in zip(jr.per_sample, pr.per_sample):
        assert sorted(a) == sorted(b)
        for k in a:
            assert b[k] == pytest.approx(a[k], rel=1e-5, abs=1e-5), k
    for agg in ("mean_metrics", "std_metrics", "median_metrics"):
        a, b = getattr(jr, agg), getattr(pr, agg)
        assert list(a) == list(b)
        for k in a:
            assert b[k] == pytest.approx(a[k], rel=1e-4, abs=1e-5), (agg, k)
    assert pr.inference_ms_mean > 0 and pr.fps > 0


def test_evaluator_outputs_have_the_same_rows_and_keys(evaluated, tmp_path):
    jr, pr = evaluated
    for writer in ("write_csv", "write_summary_csv"):
        getattr(j_eval.ModelEvaluator, writer)(jr, str(tmp_path / "j.csv"))
        getattr(p_eval.ModelEvaluator, writer)(pr, str(tmp_path / "p.csv"))
        a = (tmp_path / "j.csv").read_text().splitlines()
        b = (tmp_path / "p.csv").read_text().splitlines()
        assert a[0] == b[0] and len(a) == len(b)
        assert [r.split(",")[0] for r in a] == [r.split(",")[0] for r in b]
        for ra, rb in zip(a[1:], b[1:]):
            np.testing.assert_allclose(
                np.array(rb.split(",")[1:], float),
                np.array(ra.split(",")[1:], float), rtol=1e-4, atol=2e-6)
    ra = j_eval.ModelEvaluator.report(jr, "geometry_aware").splitlines()
    rb = p_eval.ModelEvaluator.report(pr, "geometry_aware").splitlines()
    assert len(ra) == len(rb)
    assert [r.split()[0] if r.strip() else "" for r in ra if
            not r.startswith(("Generated", "Inference"))] == \
        [r.split()[0] if r.strip() else "" for r in rb if
         not r.startswith(("Generated", "Inference"))]


def test_evaluator_refuses_the_device_resident_sweep(evaluated, tmp_path):
    """The device sweep needs a pack: a loader of image files is refused."""
    pm, _ = ts.build_model_and_loss(port_config.config_from_dict(RAW),
                                    device="cpu")
    ev = p_eval.ModelEvaluator(port_config.config_from_dict(RAW), pm)
    manifest = j_synthetic.generate_synthetic_dataset(
        str(tmp_path), images_per_sensor=1, seed=6)
    files = p_sunrgbd.SunRGBDLoader(f"{tmp_path}/sunrgbd", manifest,
                                    split="test", target_height=32,
                                    target_width=32, rays_on_device=True)
    with pytest.raises(ValueError, match="packed loader"):
        ev.evaluate(files, device_resident=True)
