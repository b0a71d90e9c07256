"""Spatially parallel training in the port (``parallel.make_mesh_2d``) over
Gloo on the CPU, against one process over the same global batches and
against JAX.

The flagship (f=4, f32, the shipped AdamW with clip 1.0 and the step
schedule's warmup, rotating PCL heads, K drawn wide) takes 3 steps on
global batches of 4 on data 1 x space 2 (two ranks, each a band of the
four images' rows) and on data 2 x space 2 (four ranks, each a band of
two images), at two sizes:

- 64x64, where every level runs on bands (bands of 32, 16, 8, 4, 2 and
  1 rows at S = 2);
- 48x64, whose tail runs whole: the band of 3 rows into ``enc5`` is odd,
  so ``enc5``, the bottleneck and ``dec5`` run whole on every rank (the
  bottleneck's 1 row upsampled to 2 is padded to 3 by ``pad_to_match``)
  and ``dec4`` takes its band again.

Against one process, the code ``tests/test_torch_train_step.py`` holds
against JAX: total_loss and its four terms at every step to rtol 1e-5
(the ranks' sums run in another order), the eval step's loss, metrics
and ``pcl_max_rot`` from the initial state to rtol 1e-5, each
parameter's gradient of the first batch at the initial state within
twice one process's own distance over that batch reversed or rotated
by one, or 1e-3 (a parameter whose gradient is S times too large or too
small lies at least 0.5 away; this network's gradient moves by
percents on some parameters when only the order of the batch's samples
changes, through the FiLM batch norms' E[x^2] - E[x]^2 variance), and
the parameters within
``tests/test_torch_parallel.py``'s bound: every difference at most
sum(lr) over the steps, their median within 0.02 of it (Adam moves an
entry by about lr a step whatever its gradient's size, and scales a
parameter's gradient away, so the parameters alone would not show a
wrong factor on one of them).

On four ranks whose data rows hold one sample each (data 4, and data 2
x space 2): each rank's training-mode depth against its part of one
process's. The FiLM layers skip their batch norms for a batch of one,
and the batch is the global one, as JAX's traced shape is.

``baseline_unet`` (JAX's own spatial test model, f=4, 64x64, B=2) on
data 1 x space 4 (bands of 16 rows down to 1, where the 3x3 convs'
halo comes from a gather): its gradient of the training loss against
JAX's ``make_grad_fn`` on the same global batch, within
``tests/test_torch_parallel.py``'s 1e-3, as one process's gradient is
(``BASELINE_SEED`` says why that is checked too). That is this file's
one JAX compile; JAX's ``tests/test_parallel.py`` holds JAX's 2-D mesh to its
unsharded step.

A Trainer trains an epoch on two ranks (``hardware.spatial_parallel: 2``)
from host data and from the device feed: rank 0 alone writes its files
and checkpoint, both ranks end with the same parameters, and the epoch's
loss and validation metrics are one process's over the same batches.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread per process)
from _torch_spatial_worker import forward_case, launch, steps_case
from cadepth_tpu.training import train_state as jax_ts
from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.data import packed as p_packed
from cadepth_tpu_torch.data import synthetic as p_synthetic
from cadepth_tpu_torch.training import train_state as ts
from cadepth_tpu_torch.training.schedule import build_lr_schedule
from cadepth_tpu_torch.training.trainer import Trainer
from torch_port_common import (PCL_BIAS, assert_grads_close,
                               make_train_batch, setup_training, torch_batch)

B = 4
STEPS = 3
STEPS_PER_EPOCH = 2
SIZES = {"all_banded": (64, 64), "tail": (48, 64)}
GRID = {"1x2": (2, 2), "2x2": (4, 2)}       # (ranks, spatial)
# four ranks, each data row holding one sample: (spatial, global batch,
# the depth's tolerance relative to its largest value). Over two samples
# the FiLM batch norms' variance, flax's E[x^2] - E[x]^2 plus eps 1e-5,
# carries the round-off of a reordered sum, up to ulp(E[x^2]) / eps ~
# 1e-2 of their output; skipping those batch norms moves the depth by
# tenths of its largest value.
ONE_SAMPLE = {"data_4": (1, 4, 1e-5), "data_2_space_2": (2, 2, 1e-3)}


def flagship_raw(h: int, w: int):
    return {"model": {"architecture": "geometry_aware", "init_features": 4},
            "data": {"input_height": h, "input_width": w},
            "training": {"use_amp": False, "batch_size": B,
                         "num_epochs": 20}}


# Weights and batch of the baseline's gradient. The gradient of this tiny
# network at B=2 can be ill-conditioned: from seed 42 the port's own
# one-process gradient lies 4e-2 (relative L2, enc3 to the bottleneck's
# batch norms) from JAX's, from seed 7 1.3e-5; the test asserts that one
# process agrees first, so that the comparison has a meaning.
BASELINE_SEED = 7
BASELINE = {"model": {"architecture": "baseline_unet", "init_features": 4},
            "data": {"input_height": 64, "input_width": 64},
            "training": {"use_amp": False, "batch_size": 2,
                         "num_epochs": 20}}


def flagship_state(raw, seed: int):
    """The port's flagship drawn from ``seed``, its PCL heads rotating."""
    cfg = port_config.config_from_dict(raw)
    model, _ = ts.build_model_and_loss(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    state = model.state_dict()
    for k, v in state.items():
        if k.endswith("fc_transform.weight"):
            state[k] = torch.from_numpy(
                rng.normal(0.0, 0.002, tuple(v.shape)).astype(np.float32))
        elif k.endswith("fc_transform.bias"):
            state[k] = torch.from_numpy(PCL_BIAS.copy())
    return state


def steps_cases(spatial: int, seed: int):
    cases = {}
    for k, (name, (h, w)) in enumerate(SIZES.items()):
        raw = flagship_raw(h, w)
        rng = np.random.default_rng(seed + k)
        cases[name] = {
            "kind": "steps", "spatial": spatial, "raw": raw,
            "state": flagship_state(raw, seed + k),
            "batches": [torch_batch(make_train_batch(rng, B, h, w))
                        for _ in range(STEPS)],
            "steps_per_epoch": STEPS_PER_EPOCH}
    return cases


def trainer_raw(root: str, manifest: str, out: Path, **data):
    """One epoch of the flagship (f=4, 32x32, global batch 4, SGD) on the
    synthetic tree, over two bands of 16 rows."""
    return {
        "experiment": {"name": "sp_run"},
        "data": {"data_dir": f"{root}/sunrgbd", "manifest_path": manifest,
                 "input_height": 32, "input_width": 32, **data},
        "model": {"architecture": "geometry_aware", "init_features": 4},
        "optimization": {"optimizer": "sgd", "learning_rate": 0.01,
                         "lr_scheduler": "none", "lr_warmup_epochs": 0},
        "training": {"num_epochs": 1, "batch_size": B, "num_workers": 2,
                     "log_interval": 1, "num_vis_samples": 1,
                     "use_amp": False},
        "hardware": {"spatial_parallel": 2},
        "checkpointing": {"checkpoint_dir": str(out / "ckpts"),
                          "save_interval": 1},
        "logging": {"log_dir": str(out / "logs"),
                    "tensorboard": {"enabled": False}},
        "early_stopping": {"enabled": False},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two groups' outputs, the one-process references and JAX's
    baseline gradient."""
    work = tmp_path_factory.mktemp("torch_spatial_train")
    root = work / "data"
    manifest = p_synthetic.generate_synthetic_dataset(
        str(root), images_per_sensor=2, seed=41,
        sensor_specs={s: (32, 32, 32, 32)
                      for s in ("kv1", "kv2", "realsense", "xtion")})
    p_packed.pack_dataset(f"{root}/sunrgbd", manifest, str(root / "pack"),
                          32, 32, num_threads=2)
    runs = [("host", trainer_raw(str(root), manifest, work / "host")),
            ("device", trainer_raw(str(root), manifest, work / "device",
                                   packed_dir=f"{root}/pack",
                                   device_resident=True))]

    (jcfg, jm, jloss, _, jstate), (_, base_model, _, _, _), _ = \
        setup_training(BASELINE, seed=BASELINE_SEED, steps=0)
    base_batch = make_train_batch(np.random.default_rng(BASELINE_SEED + 1),
                                  2, 64, 64)

    two = steps_cases(2, 50)
    two["trainer"] = {"kind": "trainer", "spatial": 2, "runs": runs}
    four = steps_cases(2, 60)
    four["baseline"] = {"kind": "steps", "spatial": 4, "raw": BASELINE,
                        "state": base_model.state_dict(),
                        "grad_batch": torch_batch(base_batch)}
    for name, (spatial, b, _) in ONE_SAMPLE.items():
        raw = flagship_raw(64, 64)
        four[name] = {"kind": "forward", "spatial": spatial, "raw": raw,
                      "state": flagship_state(raw, 70),
                      "batch": torch_batch(make_train_batch(
                          np.random.default_rng(70), b, 64, 64))}
    outs = {}
    for grid, (ranks, setup) in (("1x2", (2, two)), ("2x2", (4, four))):
        d = work / grid
        d.mkdir()
        torch.save(setup, d / "setup.pt")
        outs[grid] = launch(d, ranks)

    one = {grid: {name: steps_case(setup[name], None) for name in SIZES}
           for grid, setup in (("1x2", two), ("2x2", four))}
    one["baseline"] = steps_case(four["baseline"], None)
    one.update({name: forward_case(four[name], None)
                for name in ONE_SAMPLE})
    one_trainer = {}
    for name, raw in runs:
        raw = dict(raw, hardware={"spatial_parallel": 1},
                   checkpointing={"checkpoint_dir": str(work / "one_ckpt")},
                   logging={"log_dir": str(work / "one_logs"),
                            "tensorboard": {"enabled": False}})
        tr = Trainer(port_config.config_from_dict(raw), device="cpu")
        try:
            one_trainer[name] = {"metrics": tr.train(),
                                 "history": tr.history}
        finally:
            tr.close()
    jgrads = jax_ts.make_grad_fn(jcfg, jm, jloss)(
        jstate, {k: jnp.asarray(v) for k, v in base_batch.items()})
    return {"outs": outs, "one": one, "one_trainer": one_trainer,
            "work": work,
            "jax_baseline_grads": jax.tree_util.tree_map(np.asarray,
                                                         jgrads)}


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("grid", list(GRID))
def test_flagship_steps_match_one_process(runs, grid, size):
    got = runs["outs"][grid][0][size]
    want = runs["one"][grid][size]
    cfg = port_config.config_from_dict(flagship_raw(*SIZES[size]))
    schedule = build_lr_schedule(cfg.optimization, STEPS_PER_EPOCH,
                                 cfg.training.num_epochs)
    lrs = [schedule(s) for s in range(STEPS)]
    for step, (g, w) in enumerate(zip(got["logs"], want["logs"])):
        for k in ("total_loss", "si_loss", "grad_loss", "smooth_loss",
                  "reproj_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                       err_msg=f"step {step} {k}")
    for k, w in want["eval"].items():
        np.testing.assert_allclose(got["eval"][k], w, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k, w in want["grads"].items():
        if k.endswith(("film.fc1.bias", "film.fc2.bias")):
            # they feed a batch norm: their gradient is zero but for
            # round-off (assert_grads_close's rule)
            assert got["grads"][k].abs().max() < 1e-5, k
            continue
        # a leaf S times too large or too small lies at least 0.5 away
        noise = max(rel_l2(g[k], w) for g in want["reordered_grads"])
        assert rel_l2(got["grads"][k], w) <= max(2.0 * noise, 1e-3), k
    bound = sum(lrs)
    diffs = [(got["params"][k] - w).abs().flatten()
             for k, w in want["params"].items()]
    assert max(float(d.max()) for d in diffs) <= bound
    assert float(torch.cat(diffs).median()) <= 0.02 * bound


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


@pytest.mark.parametrize("grid", list(GRID))
def test_ranks_hold_the_same_state(runs, grid):
    """Every rank logs and updates with the same all-reduced gradient."""
    outs = runs["outs"][grid]
    for size in SIZES:
        a = outs[0][size]
        for r in range(1, GRID[grid][0]):
            b = outs[r][size]
            assert a["logs"] == b["logs"]
            for k, v in a["params"].items():
                assert torch.equal(v, b["params"][k]), (size, r, k)


@pytest.mark.parametrize("name", list(ONE_SAMPLE))
def test_one_sample_a_data_row_is_one_process(runs, name):
    """A data row holding one sample of a larger batch: the FiLM layers'
    batch norms, which a batch of one skips, still run (JAX's traced
    batch is the global one), so each rank's depth is its part of one
    process's training-mode forward."""
    spatial, _, tol = ONE_SAMPLE[name]
    want = runs["one"][name]
    h = want.shape[1] // spatial
    for r in range(4):
        d, s = divmod(r, spatial)
        part = want[d:d + 1, s * h:(s + 1) * h]
        err = float((runs["outs"]["2x2"][r][name] - part).abs().max())
        assert err <= tol * float(want.abs().max()), (r, err)


def test_baseline_gradient_matches_jax(runs):
    """baseline_unet's gradient on four bands of each image against JAX's
    single-device gradient of the same global batch (f32)."""
    grads = runs["outs"]["2x2"][0]["baseline"]["grads"]
    for r in range(1, 4):
        for k, v in grads.items():
            assert torch.equal(v, runs["outs"]["2x2"][r]["baseline"]
                               ["grads"][k]), (r, k)
    one, _ = convert.to_jax(dict(runs["one"]["baseline"]["grads"]))
    assert_grads_close(one, runs["jax_baseline_grads"], 1e-3)
    got, _ = convert.to_jax(dict(grads))
    assert_grads_close(got, runs["jax_baseline_grads"], 1e-3)


@pytest.mark.parametrize("name", ["host", "device"])
def test_trainer_trains_on_bands(runs, name):
    out = {r: runs["outs"]["1x2"][r]["trainer"][name] for r in range(2)}
    assert out[0]["ranks"] == 2 and out[0]["bands"] == 2
    for k, v in out[0]["params"].items():
        assert torch.equal(v, out[1]["params"][k]), k
    logs = runs["work"] / name / "logs" / "sp_run"
    text = (logs / "training.log").read_text()
    assert text.count("epoch 1/1 ") == 1
    assert "over 2 ranks (1 data rows x 2 bands of 16 rows)" in text
    ckpts = sorted(p.name for p in (runs["work"] / name / "ckpts"
                                    / "sp_run").iterdir())
    assert "best" in ckpts and not any(c.startswith(".tmp") for c in ckpts)
    want = runs["one_trainer"][name]
    got = out[0]
    for k in ("total_loss", "abs_rel", "rmse", "delta_1.25"):
        assert np.isfinite(got["metrics"][k])
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["history"][0]["train_loss"],
                               want["history"][0]["train_loss"], rtol=1e-5)
