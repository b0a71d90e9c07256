"""The slice as a whole: the port's ``Trainer`` against the JAX package's
on the synthetic fixture, then the port's checkpoints, resume, SIGTERM
and the options it refuses.

The parity run: ``tests/test_training.py``'s ``tiny_config`` with
``geometry_aware`` at f=4 and 32x32, f32 on both sides (``use_amp``
off): 8 samples, 2 epochs of 2 steps at batch 4, validation and a panel
each epoch. The JAX Trainer builds its state, its parameters are
converted into the port's Trainer (``device="cpu"``) after
construction, and both train. Held: each epoch's train loss (rtol 1e-4),
the validation metrics (rtol 1e-3, or JAX's own measured sensitivity, as
``test_validation_metrics`` states), JAX's validation at the port's
variables, the parameters within the learning rates' sum, the CSV rows,
the TensorBoard scalar tags and steps, and the histogram tags.
"""

from __future__ import annotations

import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread per process)
from cadepth_tpu import config as jax_config
from cadepth_tpu.data import synthetic as j_synthetic
from cadepth_tpu.metrics.depth_metrics import MetricsAccumulator
from cadepth_tpu.training import trainer as j_trainer
from cadepth_tpu.training.train_state import TrainState
from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.training import trainer as p_trainer
from cadepth_tpu_torch.training.checkpoint import CheckpointManager

LR = 1e-3
STEPS = 4  # 2 epochs of 2 steps


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_trainer_fixture")
    manifest = j_synthetic.generate_synthetic_dataset(str(root),
                                                      images_per_sensor=2)
    return str(root), manifest


def tiny_raw(dataset, out: Path, **overrides):
    """tests/test_training.py's tiny_config with geometry_aware, f=4,
    f32."""
    root, manifest = dataset
    raw = {
        "experiment": {"name": "test_run"},
        "data": {"data_dir": f"{root}/sunrgbd", "manifest_path": manifest,
                 "input_height": 32, "input_width": 32},
        "model": {"architecture": "geometry_aware", "init_features": 4},
        "optimization": {"optimizer": "adam", "learning_rate": LR,
                         "lr_scheduler": "none", "lr_warmup_epochs": 0},
        "training": {"num_epochs": 2, "batch_size": 4, "num_workers": 2,
                     "log_interval": 1, "num_vis_samples": 1,
                     "use_amp": False},
        "checkpointing": {"checkpoint_dir": str(out / "ckpts"),
                          "save_interval": 1},
        "logging": {"log_dir": str(out / "logs"),
                    "tensorboard": {"enabled": False}},
        "early_stopping": {"enabled": False},
    }
    for key, value in overrides.items():
        raw.setdefault(key, {}).update(value)
    return raw


def port_config_of(dataset, out: Path, **overrides):
    return port_config.config_from_dict(tiny_raw(dataset, out, **overrides))


def _record(trainer, scalars, histograms):
    trainer.tb.add_scalar = lambda tag, value, step: scalars.append(
        (tag, int(step), float(value)))
    trainer.tb.add_histogram = lambda tag, values, step: histograms.append(
        (tag, int(step), np.asarray(values)))


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_trainer_runs")
    # JAX: no histograms (their gradient program would be a second train
    # step compile); its tags are its parameters' paths, read below
    jt = j_trainer.Trainer(jax_config.config_from_dict(
        tiny_raw(dataset, out / "j")))
    params0 = jax.tree_util.tree_map(np.asarray, jt.state.params)
    stats0 = jax.tree_util.tree_map(np.asarray, jt.state.batch_stats)
    j_scalars, j_hist = [], []
    _record(jt, j_scalars, j_hist)
    # the batches JAX's steps see, to replay them below
    train_step, eval_step = jt.train_step, jt.eval_step
    seen, val = [], []

    def record_train(state, batch):
        seen.append(jax.tree_util.tree_map(np.asarray, batch))
        return train_step(state, batch)

    def record_eval(state, batch):
        if len(val) < len(jt.val_pipe):
            val.append(jax.tree_util.tree_map(np.asarray, batch))
        return eval_step(state, batch)

    jt.train_step, jt.eval_step = record_train, record_eval
    try:
        j_final = jt.train()
        j_params = jax.tree_util.tree_map(np.asarray, jt.state.params)
        j_history, j_step = jt.history, int(jt.state.step)
    finally:
        jt.close()

    def jax_validate(state):
        acc = MetricsAccumulator()
        for b in val:
            acc.update({k: float(v) for k, v in eval_step(state, b).items()})
        return acc.average()

    # JAX's own sensitivity: the same steps from parameters moved by
    # N(0, 1e-6), validated after each epoch
    rng = np.random.default_rng(0)
    noisy = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a + rng.normal(0, 1e-6, a.shape)
                              .astype(np.float32)), params0)
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=noisy,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats0),
        opt_state=jt.tx.init(noisy))
    j_noisy = []
    for i, b in enumerate(seen):
        state, _ = train_step(state, b)
        if i % 2 == 1:
            j_noisy.append(jax_validate(state))

    pt = p_trainer.Trainer(port_config_of(
        dataset, out / "p",
        logging={"tensorboard": {"enabled": False,
                                 "log_histogram_interval": 1}}),
        device="cpu")
    pt.model.load_state_dict(convert.to_torch(params0, stats0))
    p_scalars, p_hist = [], []
    _record(pt, p_scalars, p_hist)
    try:
        p_final = pt.train()
        p_params, p_stats = convert.to_jax(pt.model.state_dict())
        p_history, p_step = pt.history, pt.train_step.updates
    finally:
        pt.close()
    # JAX's eval step at the port's final variables
    j_at_port = jax_validate(TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, p_params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, p_stats),
        opt_state=()))
    return {"out": out, "params0": params0, "j_noisy": j_noisy,
            "j_at_port": j_at_port,
            "jax": (j_final, j_params, j_history, j_step, j_scalars),
            "port": (p_final, p_params, p_history, p_step, p_scalars,
                     p_hist)}


def test_epoch_losses(runs):
    j_history, p_history = runs["jax"][2], runs["port"][2]
    assert [h["epoch"] for h in p_history] == [h["epoch"] for h in
                                                j_history] == [0, 1]
    for a, b in zip(j_history, p_history):
        assert b["train_loss"] == pytest.approx(a["train_loss"], rel=1e-4)
    assert runs["port"][3] == runs["jax"][3] == STEPS


def test_validation_metrics(runs):
    """Every validation metric of both epochs at rtol 1e-3 (atol 1e-6),
    or where JAX's own metric moves further when its starting parameters
    move by N(0, 1e-6) (the same steps replayed from them), at twice that
    measured move: the PCL heads' kernels start at zero, so Adam's first
    updates move each entry by +-lr whatever the size of its gradient,
    and the sign of a near-zero gradient entry is round-off (measured on
    this fixture: pcl_max_rot and the small smoothness loss move by up
    to ~1e-2 in JAX alone)."""
    for a, b, noisy in zip(runs["jax"][2], runs["port"][2], runs["j_noisy"]):
        assert set(a) == set(b) == set(noisy) | {"epoch", "train_loss"}
        for k in noisy:
            own = abs(noisy[k] - a[k]) / max(abs(a[k]), 1e-12)
            rel = max(1e-3, 2 * own)
            assert b[k] == pytest.approx(a[k], rel=rel, abs=1e-6), \
                (k, b[k], a[k], own)


def test_validation_at_the_same_variables(runs):
    """JAX's eval step at the port's final parameters and BN statistics
    gives the port's last validation metrics at rtol 1e-4: what differs
    above is the training's round-off, not the validation."""
    got, want = runs["port"][2][-1], runs["j_at_port"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k


def test_parameters_within_the_learning_rates(runs):
    """As tests/test_torch_train_step.py: every parameter within the sum
    of the learning rates of JAX's (Adam moves an entry by at most about
    lr a step, and near-zero gradient signs are round-off); the median
    difference far below it; and the parameters did move."""
    bound = LR * STEPS
    want = dict(torch_port_common.leaves(runs["jax"][1]))
    start = dict(torch_port_common.leaves(runs["params0"]))
    diffs, moved = [], 0.0
    for path, got in torch_port_common.leaves(runs["port"][1]):
        d = np.abs(got - want[path])
        diffs.append(d.ravel())
        moved = max(moved, float(np.abs(got - start[path]).max()))
        assert d.max() <= bound, (jax.tree_util.keystr(path), d.max())
    assert np.median(np.concatenate(diffs)) <= 0.02 * bound
    assert moved > 0.5 * LR


def test_csv_rows(runs):
    out = runs["out"]
    a = (out / "j" / "logs" / "test_run" / "metrics.csv").read_text() \
        .splitlines()
    b = (out / "p" / "logs" / "test_run" / "metrics.csv").read_text() \
        .splitlines()
    assert a[0] == b[0] == p_trainer.CSV_HEADER.strip() == \
        j_trainer.CSV_HEADER.strip()
    assert len(a) == len(b) == 3
    for ra, rb in zip(a[1:], b[1:]):
        va, vb = ra.split(","), rb.split(",")
        assert va[:2] == vb[:2]  # epoch, step
        np.testing.assert_allclose(np.array(vb[2:11], float),
                                   np.array(va[2:11], float), rtol=1e-3,
                                   atol=2e-6)
        assert va[11] == vb[11]  # learning rate


def test_tensorboard_scalar_tags_and_steps(runs):
    """The same (tag, step) pairs, in the same order; the values of the
    losses and learning rates alike."""
    js, ps = runs["jax"][4], runs["port"][4]
    assert [(t, s) for t, s, _ in js] == [(t, s) for t, s, _ in ps]
    for (tag, _, a), (_, _, b) in zip(js, ps):
        if tag in ("batch_loss/train", "loss/train", "loss/val",
                   "training/learning_rate"):
            assert b == pytest.approx(a, rel=1e-4), tag


def test_histogram_tags(runs):
    """weights/<flax path> and gradients/<flax path> for every parameter:
    the tags JAX's trainer writes (tree_leaves_with_path of its
    parameters and of their gradients, which share the tree), each
    value in the flax layout, finite, and some gradient nonzero."""
    paths = {"/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(
                 runs["params0"])}
    hist = runs["port"][5]
    for prefix in ("weights/", "gradients/"):
        for epoch in (0, 1):
            tags = [t for t, s, _ in hist if t.startswith(prefix)
                    and s == epoch]
            assert len(tags) == len(set(tags))
            assert {t.removeprefix(prefix) for t in tags} == paths
    want = dict(torch_port_common.leaves(runs["port"][1]))
    shapes = {"/".join(str(getattr(k, "key", k)) for k in p): v.shape
              for p, v in want.items()}
    for tag, _, values in hist:
        assert values.shape == shapes[tag.split("/", 1)[1]], tag
        assert np.isfinite(values).all(), tag
    assert any(np.abs(v).max() > 0 for t, _, v in hist
               if t.startswith("gradients/"))


def test_artifacts(runs):
    out = runs["out"] / "p"
    assert (out / "logs" / "test_run" / "training.log").exists()
    ckpts = out / "ckpts" / "test_run"
    assert sorted(p.name for p in ckpts.glob("step_*")) == \
        ["step_00000002", "step_00000004"]
    assert (ckpts / "best" / "state.pt").exists()
    assert "abs_rel" in runs["port"][0]


# -- the port's own: checkpoints, resume, SIGTERM, refusals -------------------


def _state(step: int, value: float):
    return {"step": step, "model": {"w": torch.full((3,), value)},
            "optimizer": {"updates": step, "mean": None, "micro": 0}}


def test_checkpoint_retention_best_and_atomic_names(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_n=2)
    for step, metric in ((1, 0.7), (2, 0.5), (3, 0.6), (4, 0.65)):
        mgr.save(_state(step, float(step)), epoch=step - 1,
                 metrics={"abs_rel": metric}, is_best=metric == 0.5)
    kept = sorted(p.name for p in (tmp_path / "ck").glob("step_*"))
    assert kept == ["step_00000003", "step_00000004"]
    assert mgr.latest_checkpoint().endswith("step_00000004")
    assert mgr.best_metric_value() == 0.5
    best, meta = mgr.restore_with_meta(str(mgr.best_dir))
    assert best["step"] == 2 and meta["epoch"] == 1
    assert torch.equal(best["model"]["w"], torch.full((3,), 2.0))
    # a write cut off mid-way leaves only a temporary name, which
    # --resume latest never picks
    (tmp_path / "ck" / ".tmp_step_00000009").mkdir()
    assert mgr.latest_checkpoint().endswith("step_00000004")
    assert not list((tmp_path / "ck").glob("*.meta.json"))


def test_checkpoint_async_save_snapshots_at_once(tmp_path):
    """blocking=False copies the tensors at once (the step then changes
    them in place) and writes them on a thread; the next save, a lookup
    or finalize() lands it and runs best/ and retention."""
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last_n=2)
    state = _state(1, 1.0)
    path1 = mgr.save(state, epoch=0, metrics={"abs_rel": 0.7}, is_best=True,
                     blocking=False)
    state["model"]["w"].fill_(99.0)  # the next step, in place
    mgr.save(_state(2, 2.0), epoch=1, metrics={"abs_rel": 0.6},
             is_best=True, blocking=False)
    assert torch.equal(mgr.restore(path1)["model"]["w"],
                       torch.full((3,), 1.0))
    assert mgr.best_metric_value() == 0.6
    assert mgr.latest_checkpoint().endswith("step_00000002")
    restored, meta = mgr.restore_with_meta(mgr.latest_checkpoint())
    assert restored["step"] == 2 and meta["epoch"] == 1
    assert Path(path1).exists()


def test_trainer_resumes_from_latest(dataset, tmp_path):
    t1 = p_trainer.Trainer(port_config_of(dataset, tmp_path), device="cpu")
    t1.train()
    saved = {k: v.clone() for k, v in t1.model.state_dict().items()}
    opt_state = t1.optimizer.state_dict()
    t1.close()
    cfg2 = port_config_of(dataset, tmp_path, training={"num_epochs": 3},
                          checkpointing={"resume_from": "latest"})
    t2 = p_trainer.Trainer(cfg2, device="cpu")
    try:
        assert t2.start_epoch == 2
        assert t2.train_step.updates == t2.optimizer.updates == STEPS
        for k, v in t2.model.state_dict().items():
            assert torch.equal(v, saved[k]), k
        a = opt_state["base"]["state"]
        b = t2.optimizer.state_dict()["base"]["state"]
        assert a.keys() == b.keys()
        for i in a:
            for k in a[i]:
                assert torch.equal(a[i][k], b[i][k]), (i, k)
        t2.train()
        assert [h["epoch"] for h in t2.history] == [2]
        assert np.isfinite(t2.history[0]["train_loss"])
        assert t2.train_step.updates == STEPS + 2
    finally:
        t2.close()


def test_preemption_checkpoint_and_resume(dataset, tmp_path):
    """As tests/test_training.py holds for JAX: SIGTERM mid-epoch, the
    trainer finishes the in-flight batch, saves, and stops; close()
    restores the SIGTERM disposition; --resume latest continues from
    the saved step."""
    raw = dict(training={"num_epochs": 3, "batch_size": 4})
    tr = p_trainer.Trainer(port_config_of(dataset, tmp_path, **raw),
                           device="cpu")
    orig_step = tr.train_step
    calls = {"n": 0}

    class Preempting:
        def __getattr__(self, name):
            return getattr(orig_step, name)

        def __call__(self, batch):
            calls["n"] += 1
            if calls["n"] == 2:
                signal.raise_signal(signal.SIGTERM)
            return orig_step(batch)

    tr.train_step = Preempting()
    tr.train()
    assert tr._preempted and calls["n"] == 2
    saved_step = orig_step.updates
    assert saved_step == 2
    assert tr.ckpt.latest_checkpoint().endswith("step_00000002")
    installed = tr._orig_sigterm
    tr.close()
    assert signal.getsignal(signal.SIGTERM) == installed
    tr2 = p_trainer.Trainer(port_config_of(
        dataset, tmp_path, checkpointing={"resume_from": "latest"}, **raw),
        device="cpu")
    try:
        assert tr2.train_step.updates == saved_step
        assert tr2.start_epoch == 1
    finally:
        tr2.close()


# (the ids name ROADMAP.md Queue 1 item 8, spatial parallelism)
@pytest.mark.parametrize("overrides,match", [
    ({"data": {"device_resident": True},
      "hardware": {"spatial_parallel": 2}}, "packed_dir"),
    ({"hardware": {"spatial_parallel": 2}}, None),
], ids=["overrides0-Queue 1, item 8", "overrides1-Queue 1, item 8"])
def test_unported_options_raise(dataset, tmp_path, overrides, match):
    """hardware.spatial_parallel 2 without a process group trains whole
    images on the one device, as JAX's trainer does on one device; the
    device feed still asks for its pack. (A group that breaks the
    data x space rule raises: tests/test_torch_parallel.py.)"""
    cfg = port_config_of(dataset, tmp_path, training={"num_epochs": 1},
                         **overrides)
    if match is not None:
        with pytest.raises(ValueError, match=match):
            p_trainer.Trainer(cfg, device="cpu")
        return
    tr = p_trainer.Trainer(cfg, device="cpu")
    try:
        assert tr.dp is None and tr.model.space is None
        metrics = tr.train()
        assert np.isfinite(metrics["abs_rel"])
        assert all(np.isfinite(h["train_loss"]) for h in tr.history)
    finally:
        tr.close()


@pytest.mark.parametrize("model,cls", [
    ({"architecture": "baseline_unet"}, "BaselineUNet"),
    ({"variant": "lightweight"}, "LightweightGeometryNetwork"),
])
def test_trainer_trains_the_other_families(dataset, tmp_path, model, cls):
    """The families the port once refused train one tiny epoch (f=4,
    32x32): a finite loss, validation metrics and a checkpoint."""
    cfg = port_config_of(dataset, tmp_path, model=model,
                         training={"num_epochs": 1})
    tr = p_trainer.Trainer(cfg, device="cpu")
    try:
        assert type(tr.model).__name__ == cls
        tr.train()
        assert [h["epoch"] for h in tr.history] == [0]
        assert np.isfinite(tr.history[0]["train_loss"])
        assert tr.ckpt.latest_checkpoint() is not None
    finally:
        tr.close()


def test_more_than_one_card_with_data_parallel_raises(dataset, tmp_path,
                                                      monkeypatch):
    """Several cards seen outside a process group: the Trainer names the
    launch command instead of training on one of them; a single process
    otherwise trains without a group."""
    cfg = port_config_of(dataset, tmp_path)
    assert cfg.hardware.data_parallel
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        p_trainer.data_parallel_group(cfg, torch.device("cuda"))
    assert p_trainer.data_parallel_group(cfg, torch.device("cpu")) is None
    cfg.hardware.num_devices = 1
    assert p_trainer.data_parallel_group(cfg, torch.device("cuda")) is None
    cfg.hardware.num_devices = 0
    cfg.hardware.data_parallel = False
    assert p_trainer.data_parallel_group(cfg, torch.device("cuda")) is None


def test_a_group_of_one_trains_without_collectives(dataset, tmp_path,
                                                   monkeypatch):
    """A process group of one rank gives no DataParallel (its steps are
    the single process's, and each collective would cost host time), but
    a num_devices that is not the group's size still raises."""
    cfg = port_config_of(dataset, tmp_path)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 1)
    for n in (0, 1):
        cfg.hardware.num_devices = n
        assert p_trainer.data_parallel_group(cfg, torch.device("cpu")) is None
    cfg.hardware.num_devices = 2
    with pytest.raises(ValueError, match="num_devices 2"):
        p_trainer.data_parallel_group(cfg, torch.device("cpu"))


def test_trainer_asks_for_the_card_by_default(dataset, tmp_path,
                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        p_trainer.Trainer(port_config_of(dataset, tmp_path))
