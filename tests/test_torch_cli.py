"""The port's train and evaluate CLIs (``python -m cadepth_tpu_torch.cli.
train`` / ``.evaluate``) with ``--device cpu`` on the synthetic fixture
and a tiny YAML: the files each writes, resume, and their refusals."""

from __future__ import annotations

import csv
import subprocess
import sys
from pathlib import Path

import pytest

import torch_port_common  # noqa: F401  (one torch thread per process)
from cadepth_tpu_torch.cli import evaluate as evaluate_cli
from cadepth_tpu_torch.cli import train as train_cli
from cadepth_tpu_torch.data.synthetic import generate_synthetic_dataset

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    """The port's fixture (12 scenes) and a YAML in the shape of the
    shipped config: geometry_aware at f=4, 32x32, f32, 2 epochs."""
    root = tmp_path_factory.mktemp("torch_cli")
    manifest = generate_synthetic_dataset(str(root), images_per_sensor=3,
                                          seed=8)
    cfg = root / "tiny.yaml"
    cfg.write_text(f"""
experiment: {{name: "cli_run", seed: 2}}
data:
  data_dir: "{root}/sunrgbd"
  manifest_path: "{manifest}"
  input_height: 32
  input_width: 32
model: {{architecture: "baseline_unet", init_features: 4}}
optimization: {{optimizer: "adamw", learning_rate: 1.0e-3, lr_warmup_epochs: 1}}
training: {{num_epochs: 2, batch_size: 4, num_workers: 2, log_interval: 1,
           num_vis_samples: 2, use_amp: false}}
checkpointing: {{checkpoint_dir: "{root}/ckpts", save_interval: 1,
                save_best_only: false}}
logging: {{log_dir: "{root}/logs",
          tensorboard: {{enabled: true, log_histogram_interval: 2}}}}
early_stopping: {{enabled: false}}
experiments:
  tiny_geometry:
    model: {{architecture: "geometry_aware"}}
""")
    return root, cfg


@pytest.fixture(scope="module")
def trained(tiny_yaml):
    root, cfg = tiny_yaml
    rc = train_cli.main(["--config", str(cfg), "--experiment",
                         "tiny_geometry", "--device", "cpu"])
    return root, cfg, rc


def test_train_cli_writes_its_outputs(trained):
    root, _, rc = trained
    assert rc == 0
    logs = root / "logs" / "cli_run"
    assert "Training complete" in (logs / "training.log").read_text()
    rows = list(csv.reader((logs / "metrics.csv").open()))
    assert len(rows[0]) == 13 and len(rows) == 3
    assert [r[0] for r in rows[1:]] == ["0", "1"]
    ckpts = root / "ckpts" / "cli_run"
    assert sorted(p.name for p in ckpts.glob("step_*")) == \
        ["step_00000003", "step_00000006"]
    assert (ckpts / "best" / "state.pt").exists()
    assert (ckpts / "best" / "meta.json").exists()
    events = b"".join(p.read_bytes() for p in
                      (logs / "tensorboard").rglob("*") if p.is_file())
    for tag in (b"loss/train", b"predictions/sample_1",
                b"weights/enc1/conv1/kernel", b"gradients/enc1/conv1/kernel"):
        assert tag in events, tag


@pytest.mark.parametrize("which", ["best", "latest", "path"])
def test_evaluate_cli_writes_its_outputs(trained, tmp_path, which):
    root, cfg, _ = trained
    ckpt = which if which != "path" else \
        str(root / "ckpts" / "cli_run" / "step_00000003")
    out = tmp_path / "eval"
    rc = evaluate_cli.main([
        "--checkpoint", ckpt, "--config", str(cfg), "--experiment",
        "tiny_geometry", "--output", str(out), "--num-vis", "2",
        "--batch-size", "4", "--max-samples", "8", "--save-predictions",
        "--device", "cpu"])
    assert rc == 0
    per_sample = list(csv.reader((out / "per_sample_metrics.csv").open()))
    assert per_sample[0][:3] == ["sample", "abs_rel", "sq_rel"]
    assert len(per_sample) == 1 + 8
    summary = list(csv.reader((out / "summary_metrics.csv").open()))
    assert summary[0] == ["metric", "mean", "std", "median"]
    assert len(summary) == 1 + 12
    assert "Samples evaluated: 8" in (out / "report.txt").read_text()
    assert sorted(p.name for p in (out / "visualizations").iterdir()) == [
        "comparison_000.png", "comparison_001.png",
        "comprehensive_000.png", "comprehensive_001.png"]
    assert len(list((out / "predictions").iterdir())) == 8


def test_train_cli_resumes_from_latest(trained, tmp_path):
    root, cfg, _ = trained
    text = cfg.read_text().replace("num_epochs: 2", "num_epochs: 3")
    cfg3 = tmp_path / "three.yaml"
    cfg3.write_text(text)
    rc = train_cli.main(["--config", str(cfg3), "--experiment",
                         "tiny_geometry", "--resume", "latest",
                         "--tensorboard", "false", "--device", "cpu"])
    assert rc == 0
    log = (root / "logs" / "cli_run" / "training.log").read_text()
    assert "Resumed from" in log and "step_00000006 at epoch 2" in log
    rows = list(csv.reader((root / "logs" / "cli_run" / "metrics.csv")
                           .open()))
    assert [r[0] for r in rows[1:]] == ["0", "1", "2"]
    assert rows[-1][1] == "9"


def test_evaluate_cli_without_checkpoints(tiny_yaml, tmp_path):
    _, cfg = tiny_yaml
    text = cfg.read_text().replace("/ckpts", "/no_ckpts")
    other = tmp_path / "other.yaml"
    other.write_text(text)
    assert evaluate_cli.main(["--checkpoint", "latest", "--config",
                              str(other), "--experiment", "tiny_geometry",
                              "--device", "cpu"]) == 1


def test_cli_refusals(tiny_yaml):
    _, cfg = tiny_yaml
    # the JAX CLI's behaviour for an unknown experiment block
    with pytest.raises(KeyError):
        train_cli.main(["--config", str(cfg), "--experiment", "nonexistent",
                        "--device", "cpu"])
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--device", "tpu"])
    assert train_cli.parse_args([]).device == "cuda"
    assert evaluate_cli.parse_args(["--checkpoint", "best"]).device == "cuda"


def test_train_cli_trains_baseline_unet(tiny_yaml, tmp_path):
    """The YAML's base model, baseline_unet at f=4, 32x32, trains through
    the CLI (one epoch, outputs under their own directories)."""
    _, cfg = tiny_yaml
    text = cfg.read_text().replace("num_epochs: 2", "num_epochs: 1")
    for key in ("ckpts", "logs"):
        text = text.replace(f"{cfg.parent}/{key}", f"{tmp_path}/{key}")
    base = tmp_path / "base.yaml"
    base.write_text(text)
    assert train_cli.main(["--config", str(base), "--tensorboard", "false",
                           "--device", "cpu"]) == 0
    log = (tmp_path / "logs" / "cli_run" / "training.log").read_text()
    assert "Training complete" in log
    assert (tmp_path / "ckpts" / "cli_run" / "best" / "state.pt").exists()


def test_module_entry_point_runs(tiny_yaml):
    """``python -m cadepth_tpu_torch.cli.train --help`` from the repo."""
    proc = subprocess.run(
        [sys.executable, "-m", "cadepth_tpu_torch.cli.train", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--resume" in proc.stdout
