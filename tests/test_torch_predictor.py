"""The port's ``Predictor`` against ``cadepth_tpu.inference.Predictor``,
both from the same converted state, at init_features 8, 64x64 and
batch_size 4 in f32 (atol and rtol 1e-3 on depth in metres)."""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cadepth_tpu import config as jax_config
from cadepth_tpu.inference import Predictor as JaxPredictor
from cadepth_tpu.training.train_state import TrainState, build_model_and_loss
from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.inference import Predictor

from torch_port_common import init_random

H = W = 64
BATCH = 4
RAW = {"model": {"architecture": "geometry_aware", "init_features": 8},
       "data": {"input_height": H, "input_width": W},
       "training": {"use_amp": False}}


def _k(rng, n):
    k = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    k[:, 0, 0] = rng.uniform(0.8, 1.2, n) * W
    k[:, 1, 1] = rng.uniform(0.8, 1.2, n) * W
    k[:, 0, 2] = rng.uniform(0.4, 0.6, n) * W
    k[:, 1, 2] = rng.uniform(0.4, 0.6, n) * H
    return k


@pytest.fixture(scope="module")
def predictors():
    rng = np.random.default_rng(21)
    jcfg = jax_config.config_from_dict(RAW)
    model, _ = build_model_and_loss(jcfg)
    k4 = np.array([[W, W, W / 2, H / 2]] * 2, np.float32)
    sample = (jnp.zeros((2, H, W, 3)), jnp.zeros((2, H, W, 3)),
              jnp.asarray(k4))
    params, stats = init_random(model, rng, *sample)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=())
    want = JaxPredictor(jcfg, state, batch_size=BATCH)
    got = Predictor(port_config.config_from_dict(RAW),
                    convert.to_torch(params, stats), batch_size=BATCH,
                    device="cpu")
    return want, got


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("n", [BATCH, 3, 1])
@pytest.mark.parametrize("given_k", [True, False])
def test_predict_matches_jax(predictors, n, given_k):
    """A full batch, and short ones that are zero-padded to the batch;
    given intrinsics, and the default centered pinhole."""
    want_p, got_p = predictors
    rng = np.random.default_rng(n + 10 * given_k)
    rgb = rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32)
    k = _k(rng, n) if given_k else None
    got = got_p.predict(rgb, k)
    assert got.shape == (n, H, W, 1) and got.dtype == np.float32
    _close(got, want_p.predict(rgb, k))


def test_single_image_without_batch_axis(predictors):
    want_p, got_p = predictors
    rgb = np.random.default_rng(5).uniform(0, 1, (H, W, 3)).astype(np.float32)
    _close(got_p.predict(rgb), want_p.predict(rgb))


def test_predict_stream_keeps_order(predictors):
    want_p, got_p = predictors
    rng = np.random.default_rng(6)
    requests = [rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32)
                for n in (4, 2, 3, 1)]
    requests[1] = (requests[1], _k(rng, 2))
    got = list(got_p.predict_stream(iter(requests), depth=2))
    want = list(want_p.predict_stream(iter(requests), depth=2))
    assert [g.shape[0] for g in got] == [4, 2, 3, 1]
    for g, w in zip(got, want):
        _close(g, w)


def test_device_batch_path(predictors):
    """A tensor already on the predictor's device at its full shape is
    served without host staging, with the same answer."""
    _, got_p = predictors
    rng = np.random.default_rng(7)
    rgb = rng.uniform(0, 1, (BATCH, H, W, 3)).astype(np.float32)
    k = _k(rng, BATCH)
    np.testing.assert_array_equal(
        got_p.predict(torch.from_numpy(rgb), torch.from_numpy(k)),
        got_p.predict(rgb, k))
    np.testing.assert_array_equal(got_p.predict(torch.from_numpy(rgb)),
                                  got_p.predict(rgb))
    with pytest.raises(ValueError, match="shape"):
        got_p.predict(torch.from_numpy(rgb[:2]))
    with pytest.raises(ValueError, match="float32"):
        got_p.predict(torch.from_numpy(rgb).double())


def test_input_validation(predictors):
    _, got_p = predictors
    with pytest.raises(ValueError, match="64x64"):
        got_p.predict(np.zeros((1, 32, 64, 3), np.float32))
    with pytest.raises(ValueError, match="batch_size"):
        got_p.predict(np.zeros((BATCH + 1, H, W, 3), np.float32))


def test_benchmark_reports_latency(predictors):
    _, got_p = predictors
    stats = got_p.benchmark(iterations=2, warmup=1)
    assert stats["batch_size"] == BATCH
    assert 0 < stats["p50_ms"] <= stats["p95_ms"] <= stats["p99_ms"]
    assert stats["images_per_sec"] > 0


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(port_config.config_from_dict(RAW), batch_size=1)


RAW_HOST_RAYS = dict(RAW, data={"input_height": H, "input_width": W,
                                "compute_rays": False})


def test_unported_ray_source_is_refused():
    """With data.compute_rays false, requests carry host ray grids, so a
    tensor already on the device (whose rays only the device could
    derive) is refused, as JAX's Predictor refuses it."""
    got = Predictor(port_config.config_from_dict(RAW_HOST_RAYS),
                    batch_size=BATCH, device="cpu")
    rgb = torch.zeros((BATCH, H, W, 3))
    with pytest.raises(ValueError, match="compute_rays"):
        got.predict(rgb)


@pytest.mark.parametrize("n,given_k", [(BATCH, True), (3, True),
                                       (2, False)])
def test_host_ray_grids_match_jax(n, given_k):
    """data.compute_rays false: the ray grids come from the host loader's
    _compute_rays (the port's copy) for each request's K, k4 goes to the
    device as before; depths against JAX's Predictor with the same
    config and converted state (atol and rtol 1e-3), and the grids are
    the ones the port's loader makes."""
    from cadepth_tpu_torch.data.sunrgbd import SunRGBDLoader

    rng = np.random.default_rng(31)
    jcfg = jax_config.config_from_dict(RAW_HOST_RAYS)
    model, _ = build_model_and_loss(jcfg)
    k4 = np.array([[W, W, W / 2, H / 2]] * 2, np.float32)
    params, stats = init_random(model, rng, jnp.zeros((2, H, W, 3)),
                                jnp.zeros((2, H, W, 3)), jnp.asarray(k4))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=())
    want_p = JaxPredictor(jcfg, state, batch_size=BATCH)
    got_p = Predictor(port_config.config_from_dict(RAW_HOST_RAYS),
                      convert.to_torch(params, stats), batch_size=BATCH,
                      device="cpu")
    rgb = rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32)
    k = _k(rng, n) if given_k else None
    batch = got_p._make_batch(rgb, k)
    kk = batch["intrinsics"].numpy()
    assert batch["rays"].shape == (BATCH, H, W, 3)
    for i in range(BATCH):
        np.testing.assert_array_equal(
            batch["rays"][i].numpy(), SunRGBDLoader._compute_rays(kk[i], H, W))
    _close(got_p.predict(rgb, k), want_p.predict(rgb, k))
