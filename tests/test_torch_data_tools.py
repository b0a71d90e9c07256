"""The port's data-tool and comparison CLIs against the JAX package's
(``cli/``, each run in a subprocess) on one small synthetic SUN RGB-D
tree, and the last geometry and memory helpers against JAX's.

- ``validate_sunrgbd``: the same manifest JSON, byte for byte, and the
  same summary;
- ``preprocess_rays`` (``--device cpu``; JAX's with its default platform,
  the CPU here): the same ``rays.bin`` files, at the images' own sizes
  (``--native-resolution``) and at a given one: the same headers, the
  floats within 3 ulp (ROADMAP.md Queue 3);
- ``pack_dataset``: the same pack files, byte for byte;
- ``compare_models`` on evaluate output directories: the same report;
- ``rays_to_world`` and ``ray_depth`` within 1e-6 of JAX's;
- ``estimate_memory_mb`` equal to JAX's for the same parameters.
"""

from __future__ import annotations

import csv
import filecmp
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread per process)
from cadepth_tpu.geometry import rays as j_rays
from cadepth_tpu.models import factory as j_factory
from cadepth_tpu_torch.cli import compare_models as p_compare
from cadepth_tpu_torch.cli import pack_dataset as p_pack
from cadepth_tpu_torch.cli import preprocess_rays as p_rays_cli
from cadepth_tpu_torch.cli import validate_sunrgbd as p_validate
from cadepth_tpu_torch.data.synthetic import generate_synthetic_dataset
from cadepth_tpu_torch.geometry import rays as p_rays
from cadepth_tpu_torch.geometry.io import (load_intrinsics_txt,
                                           load_ray_directions)
from cadepth_tpu_torch.metrics.depth_metrics import METRIC_NAMES
from cadepth_tpu_torch.models import factory as p_factory
from torch_port_common import sample_inputs

REPO = Path(__file__).resolve().parents[1]
CLI_TIMEOUT_S = 120


def jax_cli(name: str, *args) -> str:
    """Run the JAX package's ``cli/<name>.py``; its standard output."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "cli" / f"{name}.py"), *map(str, args)],
        cwd=REPO, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two scenes a sensor, kv2's RGB larger than its depth (the
    generator's sizes), with no rays.bin."""
    root = tmp_path_factory.mktemp("torch_data_tools")
    manifest = generate_synthetic_dataset(str(root / "data"),
                                          images_per_sensor=2, seed=41)
    return root, root / "data" / "sunrgbd", Path(manifest)


def test_validate_matches_jax(tree, capsys):
    root, data, _ = tree
    want = jax_cli("validate_sunrgbd", data, root / "manifest_jax.json")
    assert p_validate.main([str(data), str(root / "manifest_port.json")]) \
        == 0
    got = capsys.readouterr().out
    assert filecmp.cmp(root / "manifest_jax.json", root / "manifest_port.json",
                       shallow=False)
    assert got.replace("manifest_port", "manifest_jax") == want


@pytest.mark.parametrize("size", [["--native-resolution"],
                                  ["--height", "24", "--width", "40"]])
def test_preprocess_rays_matches_jax(tree, tmp_path, size):
    _, data, _ = tree
    jax_tree, port_tree = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(data, jax_tree)
    shutil.copytree(data, port_tree)
    jax_cli("preprocess_rays", "--data_dir", jax_tree, *size)
    assert p_rays_cli.main(["--data_dir", str(port_tree), "--device", "cpu",
                            *size]) == 0
    files = sorted(p.relative_to(jax_tree)
                   for p in jax_tree.rglob("rays.bin"))
    assert len(files) == 8
    assert files == sorted(p.relative_to(port_tree)
                           for p in port_tree.rglob("rays.bin"))
    for f in files:
        got, want = (load_ray_directions(t / f) for t in (port_tree, jax_tree))
        assert got.shape == want.shape
        # the same header; the floats within 3 ulp of JAX's: both files
        # hold their package's ray_grid, and the port's is within 2 ulp of
        # the exact rays (torch's CPU rsqrt is not correctly rounded),
        # JAX's within 1
        assert (port_tree / f).read_bytes()[:8] == (jax_tree / f) \
            .read_bytes()[:8]
        assert ulps(got, want).max() <= 3, f
        exact = exact_rays(load_intrinsics_txt(port_tree / f.parent
                                               / "intrinsics.txt"),
                           *got.shape[:2])
        assert ulps(got, exact).max() <= 2, f
        assert ulps(want, exact).max() <= 1, f


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place of float32 (same signs)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.astype(np.float32).view(np.int32).astype(np.int64))


def exact_rays(k: np.ndarray, h: int, w: int) -> np.ndarray:
    """ray_grid's rays from its f32 directions, normalized in float64 and
    rounded once."""
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    x = np.broadcast_to((u - k[0, 2]) / k[0, 0], (h, w))
    y = np.broadcast_to((v - k[1, 2]) / k[1, 1], (h, w))
    d = np.stack([x, y, np.ones((h, w), np.float32)], -1).astype(np.float64)
    s = np.sum((d * d).astype(np.float32), -1, keepdims=True,
               dtype=np.float32).astype(np.float64)
    return (d / np.sqrt(s)).astype(np.float32)


def test_pack_matches_jax(tree):
    root, data, manifest = tree
    common = ["--data-dir", str(data), "--manifest", str(manifest),
              "--height", "32", "--width", "40", "--threads", "2"]
    jax_cli("pack_dataset", *common, "--out", root / "pack_jax")
    assert p_pack.main(common + ["--out", str(root / "pack_port")]) == 0
    names = sorted(p.name for p in (root / "pack_jax").iterdir())
    assert names == sorted(p.name for p in (root / "pack_port").iterdir())
    assert "rgb.npy" in names and "packed_meta.json" in names
    for name in names:
        assert filecmp.cmp(root / "pack_jax" / name, root / "pack_port" / name,
                           shallow=False), name


def write_run(path: Path, rng, n: int, shift: float) -> None:
    """An evaluate CLI's per-sample CSV (its columns and format)."""
    path.mkdir(parents=True)
    with open(path / "per_sample_metrics.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["sample", *METRIC_NAMES])
        for i in range(n):
            w.writerow([i] + [f"{v:.6f}" for v in
                              rng.uniform(0.05, 0.95, len(METRIC_NAMES))
                              + shift])


@pytest.mark.parametrize("how", ["two", "scan"])
def test_compare_models_matches_jax(tmp_path, capsys, how):
    rng = np.random.default_rng(42)
    runs = tmp_path / "results"
    for name, shift in (("run_a", 0.0), ("run_b", 0.02), ("run_c", -0.01)):
        write_run(runs / name, rng, 24, shift)
    if how == "two":
        args = [runs / "run_a", runs / "run_b", "--latex"]
    else:
        args = ["--scan", runs, "--baseline", "run_b", "--metric", "rmse"]
    want = jax_cli("compare_models", *args, "--output", tmp_path / "jax.md")
    assert p_compare.main([str(a) for a in args]
                          + ["--output", str(tmp_path / "port.md")]) == 0
    got = capsys.readouterr().out
    report = (tmp_path / "jax.md").read_text()
    assert (tmp_path / "port.md").read_text() == report
    assert got.replace("port.md", "jax.md") == want
    if how == "two":
        assert "Paired t-test" in report and r"\begin{table}" in report
    else:
        assert "Ablation analysis vs baseline 'run_b'" in report


def test_rays_to_world_and_depth_match_jax():
    rng = np.random.default_rng(43)
    rays = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = q
    pose[:3, 3] = rng.normal(size=3)
    points = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    for p in (pose, pose[:3, :3] * 2.5):      # 4x4, and a scaled 3x3
        got = p_rays.rays_to_world(torch.from_numpy(rays), torch.from_numpy(p))
        want = j_rays.rays_to_world(jnp.asarray(rays), jnp.asarray(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(
            torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(
        p_rays.ray_depth(torch.from_numpy(rays), torch.from_numpy(points))
        .numpy(), np.asarray(j_rays.ray_depth(jnp.asarray(rays),
                                              jnp.asarray(points))),
        atol=1e-6)
    # a zero ray stays finite: the norm's floor
    zero = p_rays.rays_to_world(torch.zeros(3), torch.from_numpy(pose))
    assert torch.equal(zero, torch.zeros(3))


@pytest.mark.parametrize("arch", ["geometry_aware", "baseline_unet"])
def test_estimate_memory_matches_jax(arch):
    jm = j_factory.create_model(arch, init_features=4)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *sample_inputs(arch, 32, 32))["params"]
    model = p_factory.create_model(arch, init_features=4, device="cpu")
    assert p_factory.count_parameters(model) == \
        j_factory.count_parameters(shapes)
    for kw in ({}, {"activation_bytes": 4, "tensors_per_block": 6}):
        assert p_factory.estimate_memory_mb(model, 8, 240, 320, 64, **kw) \
            == j_factory.estimate_memory_mb(shapes, 8, 240, 320, 64, **kw)
    # off the card the allocator measures nothing, as JAX's without an
    # analysis
    assert p_factory.compiled_memory_analysis(model, {}, arch) == {}
