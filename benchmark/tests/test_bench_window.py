"""Rates and tails are taken over the whole window: a stall planted in
the timed path moves them."""

import time

import pytest
from conftest import tiny

import benchmark.run as run

SEED = 2 ** 31 + 61


def _train(cpu, monkeypatch, stall_s):
    from cadepth_tpu_torch.training import train_state

    calls = {"n": 0}
    step = train_state.TrainStep.__call__

    def stalled(self, batch):
        calls["n"] += 1
        if calls["n"] == 6:       # the window's first step (3 + 2 before)
            time.sleep(stall_s)
        return step(self, batch)

    monkeypatch.setattr(train_state.TrainStep, "__call__", stalled)
    cell, conf = tiny("flagship_train_b32")
    return run.execute(cell, conf, SEED, 1.0, False, cpu,
                       time.perf_counter())


def test_a_stalled_training_step_lowers_the_rate(cpu, monkeypatch):
    calm = _train(cpu, monkeypatch, 0.0)
    stalled = _train(cpu, monkeypatch, 1.5)
    for r in (calm, stalled):
        assert r["metrics"]["train_images_per_s"]["value"] == pytest.approx(
            r["attempted"] * 4 / r["window_s"])
    # the stall lies inside the window the rate is taken over
    assert stalled["window_s"] > 1.5
    assert stalled["metrics"]["train_images_per_s"]["value"] <= \
        stalled["attempted"] * 4 / 1.5
    assert stalled["metrics"]["train_images_per_s"]["value"] < \
        calm["metrics"]["train_images_per_s"]["value"]


def _serve(cpu, monkeypatch, stall_s):
    from cadepth_tpu_torch.inference import Predictor

    calls = {"n": 0}
    run_one = Predictor._run

    def stalled(self, rgb, k):
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            time.sleep(stall_s)
        return run_one(self, rgb, k)

    monkeypatch.setattr(Predictor, "_run", stalled)
    cell, conf = tiny("production_serve_b8")
    return run.execute(cell, conf, SEED, 1.5, False, cpu,
                       time.perf_counter())


def test_stalled_requests_raise_the_tail_and_lower_the_rate(cpu, monkeypatch):
    calm = _serve(cpu, monkeypatch, 0.0)
    stalled = _serve(cpu, monkeypatch, 0.3)
    m, s = calm["metrics"], stalled["metrics"]
    assert s["serve_p95_ms"]["value"] > 300.0 > m["serve_p95_ms"]["value"]
    assert s["serve_images_per_s"]["value"] < \
        0.7 * m["serve_images_per_s"]["value"]
    assert stalled["attempted"] == stalled["failed"] + round(
        s["serve_images_per_s"]["value"] * stalled["window_s"] / 2)
