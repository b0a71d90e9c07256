"""``correct`` comes out true for a sound run and false under the control
and under every fault a cell can have: a step that leaves the state as
it was, half of the batch left out (the mean over the rest), an answer
altered where it is produced. The harness's look for a chip is skipped;
the rest of a run is driven on the CPU at a tiny size, the port in
float32 so that a sound run's numbers sit at round-off."""

import time

import numpy as np
import pytest
from conftest import tiny

import benchmark.control as control
import benchmark.run as run

SEED = 2 ** 31 + 4099


def _run(name, cpu, seconds=0.5):
    cell, conf = tiny(name)
    return run.execute(cell, conf, SEED, seconds, False, cpu,
                       time.perf_counter())


def test_a_sound_training_run_is_correct(cpu):
    r = _run("flagship_train_b32", cpu)
    assert r["correct"], r["checks"]
    assert r["numbers"]["loss_gap"] < 1e-5


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        cpu, monkeypatch):
    from cadepth_tpu_torch.training import train_state

    monkeypatch.setattr(train_state.Optimizer, "update",
                        lambda self, *a, **k: True)
    r = _run("flagship_train_b32", cpu)
    assert not r["correct"]
    assert r["numbers"]["update_gap_median"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(cpu, monkeypatch):
    from cadepth_tpu_torch.training import train_state

    step = train_state.TrainStep.__call__

    def half(self, batch):
        n = batch["rgb"].shape[0] // 2
        return step(self, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(train_state.TrainStep, "__call__", half)
    assert not _run("flagship_train_b32", cpu)["correct"]


def test_a_sound_serving_run_is_correct(cpu):
    r = _run("production_serve_b8", cpu)
    assert r["correct"], r["checks"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(
        cpu, monkeypatch):
    from cadepth_tpu_torch.inference import Predictor

    run_one = Predictor._run

    def altered(self, rgb, k):
        out, n = run_one(self, rgb, k)
        return out.roll(1, 0), n          # answers handed to the wrong frames

    monkeypatch.setattr(Predictor, "_run", altered)
    assert not _run("production_serve_b8", cpu)["correct"]


@pytest.mark.parametrize("name", ["flagship_train_b32",
                                  "production_serve_b8"])
def test_the_control_reads_far_above_a_sound_run(cpu, name):
    """The reference on float8 operands, in the port's place, reads the
    cell's compared numbers far above a sound run at the same CPU size
    (the port in float32, where a sound run sits at round-off). Its
    limits are set from readings at the cell's own size on the card,
    where the control fails them (``test_bench_card.py``)."""
    cell, conf = tiny(name)
    sound = run.execute(cell, conf, SEED, 0.3, False, cpu,
                        time.perf_counter())["numbers"]
    numbers = control.readings(cell, conf, SEED, ["float8"], cpu)["float8"]
    for k in cell["limits"]:
        assert numbers[k] > 10 * sound[k] + 1e-6, (k, numbers, sound)
    assert np.isfinite(list(numbers.values())).all()
