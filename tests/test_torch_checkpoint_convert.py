"""A JAX run resumes in the port, and a port run in JAX.

A JAX ``Trainer`` (geometry_aware, f=4, 32x32, f32) trains one epoch and
saves with Orbax. JAX restores the checkpoint and ``convert.
train_state_to_torch`` loads it into the port, which saves it as its own
checkpoint and resumes from it: its next epoch's step losses match JAX's
resumed epoch (JAX's compiled step replayed from the restored state on a
fresh pipeline, as a resumed JAX Trainer runs it) at rtol 1e-4. Then the
port's checkpoint after that epoch goes back through ``convert.
train_state_to_jax``, and JAX's next epoch from it matches the port's
resumed one; the optax state converts both ways exactly. Orbax is
imported here only; the port never imports it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_common import leaves
from cadepth_tpu import config as jax_config
from cadepth_tpu.data import synthetic as j_synthetic
from cadepth_tpu.data.pipeline import InputPipeline as JaxPipeline
from cadepth_tpu.training import train_state as jax_ts
from cadepth_tpu.training import trainer as j_trainer
from cadepth_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.training import trainer as p_trainer
from cadepth_tpu_torch.training.checkpoint import CheckpointManager


def raw_config(root, manifest, out, **overrides):
    raw = {
        "experiment": {"name": "convert_run", "seed": 5},
        "data": {"data_dir": f"{root}/sunrgbd", "manifest_path": manifest,
                 "input_height": 32, "input_width": 32},
        "model": {"architecture": "geometry_aware", "init_features": 4},
        "optimization": {"optimizer": "adamw", "learning_rate": 1e-3,
                         "lr_scheduler": "none", "lr_warmup_epochs": 0},
        "training": {"num_epochs": 1, "batch_size": 4, "num_workers": 2,
                     "log_interval": 1, "use_amp": False,
                     "val_interval": 10},
        "checkpointing": {"checkpoint_dir": str(out / "ckpts"),
                          "save_interval": 1},
        "logging": {"log_dir": str(out / "logs"),
                    "tensorboard": {"enabled": False}},
        "early_stopping": {"enabled": False},
    }
    for key, value in overrides.items():
        raw.setdefault(key, {}).update(value)
    return raw


def numpy_state(state):
    return jax.tree_util.tree_map(np.asarray, state)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_convert")
    root = out / "data"
    manifest = j_synthetic.generate_synthetic_dataset(str(root),
                                                      images_per_sensor=2)
    raw = raw_config(root, manifest, out / "j")
    jt = j_trainer.Trainer(jax_config.config_from_dict(raw))
    try:
        jt.train()  # one epoch, then an Orbax checkpoint
        path = jt.ckpt.latest_checkpoint()
        cfg = jt.cfg

        def fresh_batches():
            # a resumed Trainer's new pipeline starts at its epoch 0
            return list(JaxPipeline(
                jt.train_loader, cfg.training.batch_size, shuffle=True,
                seed=cfg.experiment.seed,
                num_threads=cfg.training.num_workers,
                prefetch_depth=cfg.training.prefetch_factor,
                use_native=cfg.data.use_native_loader))

        def jax_epoch(state):
            losses = []
            for b in fresh_batches():
                state, logs = jt.train_step(state, b)
                losses.append(float(logs["total_loss"]))
            return state, losses

        # the trained state is the structure to restore into
        restored, meta = JaxCkpt(str(out / "j" / "ckpts" / "convert_run")) \
            .restore_with_meta(path, jt.state)
        restored_np = numpy_state(restored)
        _, j_losses = jax_epoch(restored)
    finally:
        jt.close()
    assert meta["epoch"] == 0 and int(restored_np.step) == 2

    # JAX -> port: convert, save as the port's checkpoint, resume
    praw = raw_config(root, manifest, out / "p",
                      training={"num_epochs": 2})
    seed = p_trainer.Trainer(port_config.config_from_dict(praw),
                             device="cpu")
    convert.train_state_to_torch(restored_np, seed.train_step)
    back = convert.train_state_to_jax(seed.train_step,
                                      numpy_state(jt.tx.init(
                                          restored_np.params)))
    mgr = CheckpointManager(str(out / "p" / "from_jax"))
    from_jax = mgr.save(seed.train_step.state_dict(), epoch=0)
    seed.close()
    praw["checkpointing"]["resume_from"] = from_jax
    pt = p_trainer.Trainer(port_config.config_from_dict(praw), device="cpu")
    p_losses = []
    step = pt.train_step

    class Recording:
        def __getattr__(self, name):
            return getattr(step, name)

        def __call__(self, batch):
            logs = step(batch)
            p_losses.append(float(logs["total_loss"]))
            return logs

    pt.train_step = Recording()
    try:
        assert pt.start_epoch == 1
        pt.train()
    finally:
        pt.close()
    port_after = pt.ckpt.latest_checkpoint()

    # port -> JAX: the port's checkpoint after its epoch, converted back;
    # JAX's next epoch from it against the port resumed from it
    praw2 = dict(praw, training=dict(praw["training"], num_epochs=3))
    praw2["checkpointing"] = dict(praw["checkpointing"],
                                  resume_from=port_after)
    pt2 = p_trainer.Trainer(port_config.config_from_dict(praw2),
                            device="cpu")
    step_count, params, stats, opt = convert.train_state_to_jax(
        pt2.train_step, numpy_state(jt.tx.init(restored_np.params)))
    jstate = jax_ts.TrainState(
        step=jnp.asarray(step_count, jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=jax.tree_util.tree_map(jnp.asarray, opt))
    _, j_losses2 = jax_epoch(jstate)
    p_losses2 = []
    step2 = pt2.train_step

    class Recording2:
        def __getattr__(self, name):
            return getattr(step2, name)

        def __call__(self, batch):
            logs = step2(batch)
            p_losses2.append(float(logs["total_loss"]))
            return logs

    pt2.train_step = Recording2()
    try:
        assert pt2.start_epoch == 2
        pt2.train()
    finally:
        pt2.close()
    return {"restored": restored_np, "back": back, "j_losses": j_losses,
            "p_losses": p_losses, "j_losses2": j_losses2,
            "p_losses2": p_losses2, "step_count": step_count}


def test_jax_checkpoint_resumes_in_the_port(run):
    assert len(run["p_losses"]) == len(run["j_losses"]) == 2
    np.testing.assert_allclose(run["p_losses"], run["j_losses"], rtol=1e-4)


def test_port_checkpoint_resumes_in_jax(run):
    assert run["step_count"] == 4
    assert len(run["p_losses2"]) == len(run["j_losses2"]) == 2
    np.testing.assert_allclose(run["p_losses2"], run["j_losses2"],
                               rtol=1e-4)


def test_train_state_round_trip_is_exact(run):
    """JAX's restored state -> port -> JAX: every leaf of the step, the
    parameters, the BN statistics and the optax state (Adam's mu, nu and
    count, the schedule's count) equal, dtypes included."""
    step, params, stats, opt = run["back"]
    want = run["restored"]
    assert step == int(want.step)
    for got, ref in ((params, want.params), (stats, want.batch_stats),
                     (opt, want.opt_state)):
        a, b = leaves(got), leaves(ref)
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y), \
                jax.tree_util.keystr(path)
