"""Serving from a checkpoint: ``Predictor.from_checkpoint``, the
``torch.export`` program (``Predictor.export`` / ``load_exported``) and
the infer CLI (``python -m cadepth_tpu_torch.cli.infer``), on the CPU.

A JAX train state of the flagship (geometry_aware, f=4, 64x64, f32;
numpy-drawn variables with rotating PCL heads) is saved with JAX's Orbax
``CheckpointManager``, carried into the port's ``TrainStep`` by
``convert.train_state_to_torch`` and saved as the port's own checkpoint
(``step_*/`` and ``best/``). Held:

- ``from_checkpoint`` with "best", "latest" and a path gives the depths
  of a ``Predictor`` built from the same ``state_dict``, bit for bit; a
  missing checkpoint raises FileNotFoundError.
- An exported program gives ``predict``'s depths within 1e-5 m, for
  ``pcl_warp`` two_pass and fused (the plain versions behind the
  registered ops on the CPU), at batch 1 and batch 8; the two programs
  differ, as the predictors do (FiLM skips its BatchNorm1d at batch 1).
- JAX's ``cli/infer.py --platform cpu`` and the port's CLI ``--device
  cpu`` on one PNG and one intrinsics.txt write the same three files;
  the ``.npy`` depths agree within 1e-3 m and the 16-bit PNGs within
  1 mm. The port's ``--export`` program reads back through
  ``load_exported``.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

import torch_port_common  # noqa: F401  (one torch thread per process)
from cadepth_tpu import config as jax_config
from cadepth_tpu.training import train_state as jax_ts
from cadepth_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from cadepth_tpu.training.schedule import build_lr_schedule as jax_schedule
from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.cli import infer as infer_cli
from cadepth_tpu_torch.inference import Predictor, load_exported
from cadepth_tpu_torch.training import train_state as ts
from cadepth_tpu_torch.training.checkpoint import CheckpointManager
from cadepth_tpu_torch.training.schedule import build_lr_schedule

from torch_port_common import init_random, make_train_batch, sample_inputs

REPO = Path(__file__).resolve().parents[1]
H = W = 64


def raw_config(ckpt_dir: Path, **model):
    return {"experiment": {"name": "serve_run", "seed": 3},
            "data": {"input_height": H, "input_width": W},
            "model": {"architecture": "geometry_aware", "init_features": 4,
                      **model},
            "training": {"use_amp": False, "num_epochs": 2},
            "checkpointing": {"checkpoint_dir": str(ckpt_dir)}}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(root, JAX config path, port config path, the port's state_dict):
    one state saved by JAX's Orbax manager and, converted, by the
    port's."""
    root = tmp_path_factory.mktemp("torch_serving")
    raws = {}
    for side in ("jax", "port"):
        raws[side] = raw_config(root / f"{side}_ckpts")
        (root / f"{side}.yaml").write_text(yaml.safe_dump(raws[side]))
    jcfg = jax_config.config_from_dict(raws["jax"])
    jm, _ = jax_ts.build_model_and_loss(jcfg)
    params, stats = init_random(jm, np.random.default_rng(17),
                                *sample_inputs("geometry_aware", H, W))
    tx = jax_ts.build_optimizer(jcfg.optimization,
                                jax_schedule(jcfg.optimization, 1, 1))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_ts.TrainState(
        step=jnp.asarray(3, jnp.int32), params=jparams,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=tx.init(jparams))
    JaxCkpt(str(root / "jax_ckpts" / "serve_run")).save(
        state, 0, {"abs_rel": 0.5}, is_best=True)

    pcfg = port_config.config_from_dict(raws["port"])
    model, loss_fn = ts.build_model_and_loss(pcfg, device="cpu")
    step = ts.make_train_step(
        pcfg, model, loss_fn,
        ts.build_optimizer(pcfg.optimization, model.parameters()),
        build_lr_schedule(pcfg.optimization, 1, 1))
    convert.train_state_to_torch(
        jax.tree_util.tree_map(np.asarray, state), step)
    CheckpointManager(str(root / "port_ckpts" / "serve_run")).save(
        step.state_dict(), 0, {"abs_rel": 0.5}, is_best=True)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    return root, root / "jax.yaml", root / "port.yaml", sd


def _request(n: int, seed: int):
    batch = make_train_batch(np.random.default_rng(seed), n, H, W)
    return batch["rgb"], batch["intrinsics"]


def _batch(rgb, k):
    """The dict an exported program takes."""
    k4 = np.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]], -1)
    return {"rgb": rgb, "intrinsics": k, "k4": k4.astype(np.float32)}


@pytest.mark.parametrize("which", ["best", "latest", "path"])
def test_from_checkpoint_equals_the_state_dict_predictor(served, which):
    root, _, port_yaml, sd = served
    cfg = port_config.load_config(str(port_yaml))
    ckpt = which if which != "path" else \
        str(root / "port_ckpts" / "serve_run" / "step_00000003")
    got = Predictor.from_checkpoint(cfg, ckpt, batch_size=4, device="cpu")
    want = Predictor(cfg, sd, batch_size=4, device="cpu")
    rgb, k = _request(3, seed=1)
    out = got.predict(rgb, k)
    assert out.shape == (3, H, W, 1) and np.isfinite(out).all()
    assert np.array_equal(out, want.predict(rgb, k))


def test_from_checkpoint_without_one_raises(served, tmp_path):
    _, _, port_yaml, _ = served
    raw = yaml.safe_load(port_yaml.read_text())
    raw["checkpointing"]["checkpoint_dir"] = str(tmp_path / "none")
    cfg = port_config.config_from_dict(raw)
    for which in ("best", "latest", str(tmp_path / "nowhere")):
        with pytest.raises(FileNotFoundError):
            Predictor.from_checkpoint(cfg, which, device="cpu")


@pytest.fixture(scope="module")
def programs(served):
    """{(pcl_warp, batch): (predictor, program)} over the converted
    state."""
    root, _, port_yaml, sd = served
    raw = yaml.safe_load(port_yaml.read_text())
    out = {}
    for mode, b in (("two_pass", 1), ("two_pass", 8), ("fused", 8)):
        raw["model"]["pcl_warp"] = mode
        pred = Predictor(port_config.config_from_dict(raw), sd, batch_size=b,
                         device="cpu")
        path = root / f"{mode}_b{b}.pt2"
        assert pred.export(str(path)) == path.stat().st_size > 0
        out[mode, b] = pred, load_exported(str(path))
    return out


@pytest.mark.parametrize("mode,b", [("two_pass", 1), ("two_pass", 8),
                                    ("fused", 8)])
def test_exported_program_equals_predict(programs, mode, b):
    pred, fn = programs[mode, b]
    rgb, k = _request(b, seed=b)
    got = fn(_batch(rgb, k)).numpy()
    want = pred.predict(rgb, k)
    assert got.shape == want.shape == (b, H, W, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_batch_1_and_batch_8_programs_differ(programs):
    """FiLM's BatchNorm1d runs at batch 8 and not at batch 1, so one image
    gets another depth from each program, as from each predictor."""
    rgb, k = _request(8, seed=4)
    one = programs["two_pass", 1][1](_batch(rgb[:1], k[:1])).numpy()
    eight = programs["two_pass", 8][1](_batch(rgb, k)).numpy()
    assert np.abs(one[0] - eight[0]).max() > 1e-3
    np.testing.assert_allclose(
        one, programs["two_pass", 1][0].predict(rgb[:1], k[:1]), atol=1e-5)


@pytest.fixture(scope="module")
def inferred(served):
    """Both infer CLIs on one PNG and one intrinsics.txt."""
    root, jax_yaml, port_yaml, _ = served
    rng = np.random.default_rng(9)
    img = cv2.GaussianBlur(rng.integers(0, 256, (80, 96, 3), np.uint8),
                           (5, 5), 0)
    cv2.imwrite(str(root / "scene.png"), img)
    np.savetxt(root / "intrinsics.txt",
               [[88.0, 0, 50.0], [0, 90.0, 38.0], [0, 0, 1]])
    common = ["--checkpoint", "best", "--image", str(root / "scene.png"),
              "--intrinsics", str(root / "intrinsics.txt"), "--save-npy"]
    proc = subprocess.run(
        [sys.executable, str(REPO / "cli" / "infer.py"), *common,
         "--config", str(jax_yaml), "--output", str(root / "jax_out"),
         "--platform", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    program = root / "infer.pt2"
    rc = infer_cli.main([*common, "--config", str(port_yaml),
                         "--output", str(root / "port_out"), "--export",
                         str(program), "--device", "cpu"])
    assert rc == 0
    return root, program


def test_infer_cli_matches_jax(inferred):
    root, _ = inferred
    jax_out, port_out = root / "jax_out", root / "port_out"
    names = sorted(p.name for p in jax_out.iterdir())
    assert names == sorted(p.name for p in port_out.iterdir()) == [
        "scene_depth.npy", "scene_depth.png", "scene_depth_vis.png"]
    got = np.load(port_out / "scene_depth.npy")
    want = np.load(jax_out / "scene_depth.npy")
    assert got.shape == want.shape == (80, 96)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    png = [cv2.imread(str(d / "scene_depth.png"), cv2.IMREAD_UNCHANGED)
           for d in (port_out, jax_out)]
    assert png[0].dtype == png[1].dtype == np.uint16
    assert np.abs(png[0].astype(int) - png[1].astype(int)).max() <= 1


def test_infer_cli_export_reads_back(inferred, served):
    root, program = inferred
    _, _, port_yaml, sd = served
    fn = load_exported(str(program))
    pred = Predictor(port_config.load_config(str(port_yaml)), sd,
                     device="cpu")
    rgb, k = _request(1, seed=12)
    np.testing.assert_allclose(fn(_batch(rgb, k)).numpy(),
                               pred.predict(rgb, k), rtol=0, atol=1e-5)


def test_infer_cli_refusals(served, tmp_path):
    root, _, port_yaml, _ = served
    args = ["--config", str(port_yaml), "--output", str(tmp_path),
            "--device", "cpu"]
    assert infer_cli.main(["--checkpoint", "best", "--image",
                           str(tmp_path / "missing.png"), *args]) == 1
    cv2.imwrite(str(tmp_path / "x.png"), np.zeros((8, 8, 3), np.uint8))
    assert infer_cli.main(["--checkpoint", str(tmp_path / "nowhere"),
                           "--image", str(tmp_path / "x.png"), *args]) == 1
    assert infer_cli.parse_args(["--checkpoint", "best", "--image",
                                 "x"]).device == "cuda"
