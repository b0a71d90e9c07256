"""The GPU-resident feed in the port's consumers (``device="cpu"``): the
``Trainer`` fed from the device against the host-fed one, the quantized
and chunked Trainers, the evaluator's device sweeps against its host
sweep, and the train and evaluate CLIs with ``data.device_resident``.

The host-fed Trainer is held against JAX's in ``test_torch_trainer.py``;
here the device feed is held against the host feed, which needs no second
JAX compile. Both Trainers start from the same seeded weights; the
host-fed one is given the device feed's epoch order (``DeviceDataset``
shuffles with ``default_rng([seed, epoch])``, ``InputPipeline`` with
``default_rng(seed + epoch)``, as in JAX), so both see the same batches.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread per process)
from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch.cli import evaluate as evaluate_cli
from cadepth_tpu_torch.cli import train as train_cli
from cadepth_tpu_torch.data.device_resident import (
    ChunkedDeviceDataset,
    DevicePipeline,
)
from cadepth_tpu_torch.data.packed import PackedSunRGBDLoader, pack_dataset
from cadepth_tpu_torch.data.pipeline import InputPipeline
from cadepth_tpu_torch.data.synthetic import generate_synthetic_dataset
from cadepth_tpu_torch.evaluation import evaluator as p_eval
from cadepth_tpu_torch.training import train_state as ts
from cadepth_tpu_torch.training import trainer as p_trainer

H = W = 32
NO_AUG = {"random_crop": False, "horizontal_flip": False,
          "color_jitter": False}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """12 synthetic scenes as files and as a pack at 32x32."""
    root = tmp_path_factory.mktemp("torch_device_trainer")
    manifest = generate_synthetic_dataset(str(root), images_per_sensor=3,
                                          seed=4)
    pack_dataset(f"{root}/sunrgbd", manifest, str(root / "pack"), H, W,
                 num_threads=4)
    return root, manifest


def raw(scenes, out: Path, **overrides):
    """geometry_aware at f=4, 32x32, f32, 2 epochs of 3 steps from the
    pack held on the device."""
    root, _ = scenes
    cfg = {
        "experiment": {"name": "devres", "seed": 3},
        "data": {"packed_dir": str(root / "pack"), "device_resident": True,
                 "input_height": H, "input_width": W, "compute_rays": True},
        "model": {"architecture": "geometry_aware", "init_features": 4},
        "optimization": {"optimizer": "adam", "learning_rate": 1e-3,
                         "lr_scheduler": "none", "lr_warmup_epochs": 0},
        "training": {"num_epochs": 2, "batch_size": 4, "num_workers": 2,
                     "log_interval": 1, "num_vis_samples": 1,
                     "use_amp": False, "max_val_samples": 8},
        "checkpointing": {"checkpoint_dir": str(out / "ckpts"),
                          "save_interval": 1},
        "logging": {"log_dir": str(out / "logs"),
                    "tensorboard": {"enabled": False}},
        "early_stopping": {"enabled": False},
    }
    for key, value in overrides.items():
        cfg.setdefault(key, {}).update(value)
    return cfg


def trainer_of(scenes, out, **overrides):
    return p_trainer.Trainer(
        port_config.config_from_dict(raw(scenes, out, **overrides)),
        device="cpu")


def device_order(pipe: InputPipeline):
    """InputPipeline's epoch indices replaced by DeviceDataset's order."""
    def indices():
        n = len(pipe.loader)
        order = np.arange(n)
        np.random.default_rng([pipe.seed, pipe._epoch]).shuffle(order)
        return order
    return indices


def test_device_fed_trainer_matches_host_fed(scenes, tmp_path):
    """Augmentation off, f32, 2 epochs: the same epoch losses and
    validation metrics, to the bit."""
    dev = trainer_of(scenes, tmp_path / "dev",
                     data={"augmentation": NO_AUG})
    host = trainer_of(scenes, tmp_path / "host",
                      data={"augmentation": NO_AUG,
                            "device_resident": False})
    try:
        assert isinstance(dev.train_pipe, DevicePipeline)
        assert isinstance(host.train_pipe, InputPipeline)
        # train and validation share one upload (non-filtering splits)
        assert dev.val_pipe.dataset.rgb is dev.train_pipe.dataset.rgb
        assert dev.val_pipe.dataset.split == dev.cfg.data.val_split != \
            dev.train_pipe.dataset.split
        assert len(dev.train_pipe) == len(host.train_pipe) == 3
        assert len(dev.val_pipe) == len(host.val_pipe) == 2
        host.train_pipe._epoch_indices = device_order(host.train_pipe)
        dev.train()
        host.train()
        assert len(dev.history) == len(host.history) == 2
        for a, b in zip(dev.history, host.history):
            assert a == b
            assert np.isfinite(a["train_loss"]) and "abs_rel" in a
    finally:
        dev.close()
        host.close()


@pytest.mark.parametrize("overrides", [
    {"device_resident_dtype": "quantized"},
    {"device_resident_dtype": "bfloat16"},
    {"device_resident_chunk_samples": 5},
    {"device_resident_chunk_samples": 5,
     "device_resident_dtype": "quantized"},
], ids=["quantized", "bfloat16", "chunked", "chunked_quantized"])
def test_device_trainer_storages_train(scenes, tmp_path, overrides):
    """The shipped augmentation, each storage and the chunked feed: a
    finite run with the storage asked for."""
    tr = trainer_of(scenes, tmp_path, data=overrides)
    try:
        ds = tr.train_pipe.dataset
        quant = overrides.get("device_resident_dtype") == "quantized"
        bf16 = overrides.get("device_resident_dtype") == "bfloat16"
        assert ds.rgb_dtype == (torch.uint8 if quant else torch.bfloat16
                                if bf16 else torch.float32)
        assert ds.depth_dtype == (torch.uint16 if quant else torch.float32)
        assert isinstance(ds, ChunkedDeviceDataset) == \
            ("device_resident_chunk_samples" in overrides)
        assert ds.augmentation_enabled and ds.split == "train"
        metrics = tr.train()
        assert np.isfinite(metrics["abs_rel"])
        assert all(np.isfinite(h["train_loss"]) for h in tr.history)
    finally:
        tr.close()


def test_device_trainer_refusals(scenes, tmp_path):
    root, manifest = scenes
    files = {"packed_dir": "", "data_dir": f"{root}/sunrgbd",
             "manifest_path": manifest}
    with pytest.raises(ValueError, match="packed_dir"):
        trainer_of(scenes, tmp_path, data=files)
    with pytest.raises(ValueError, match="target resolution"):
        trainer_of(scenes, tmp_path, data={"input_height": 16})
    # spatial parallelism without a process group: whole images on the
    # one device, from the unsharded feed
    tr = trainer_of(scenes, tmp_path, hardware={"spatial_parallel": 2})
    try:
        assert tr.dp is None and tr.model.space is None
        assert tr.train_pipe.dataset.mesh is None
    finally:
        tr.close()


@pytest.fixture(scope="module")
def evaluator(scenes):
    cfg = port_config.config_from_dict(raw(scenes, Path("unused")))
    model, _ = ts.build_model_and_loss(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    root, _ = scenes
    loader = PackedSunRGBDLoader(str(root / "pack"), split="test",
                                 compute_rays=True, rays_on_device=True)
    return cfg, model, loader


def evaluate(evaluator, device_resident, **data_overrides):
    cfg, model, loader = evaluator
    for key, value in data_overrides.items():
        setattr(cfg.data, key, value)
    try:
        ev = p_eval.ModelEvaluator(cfg, model, p_eval.EvaluationConfig(
            warmup_iterations=1, batch_size=5))   # 12 % 5 != 0
        return ev.evaluate(loader, device_resident=device_resident)
    finally:
        cfg.data.device_resident_chunk_samples = 0
        cfg.data.device_resident_dtype = "float32"


@pytest.mark.parametrize("knobs", [
    {}, {"device_resident_chunk_samples": 3},
    {"device_resident_chunk_samples": 8}],
    ids=["resident", "chunk_below_batch", "chunk_above_batch"])
def test_evaluator_device_sweep_matches_host(evaluator, knobs):
    """Every sample once, the ragged tail trimmed, the per-sample metrics
    equal to the host sweep's."""
    host = evaluate(evaluator, False)
    dev = evaluate(evaluator, True, **knobs)
    assert dev.num_samples == host.num_samples == 12
    assert dev.per_sample == host.per_sample


def test_evaluator_quantized_chunked_sweep(evaluator):
    """Depth stored mm-exact: metrics move only by the rgb u8 rounding
    through the network (the JAX test's bounds)."""
    host = evaluate(evaluator, False)
    devq = evaluate(evaluator, True, device_resident_chunk_samples=5,
                    device_resident_dtype="quantized")
    assert devq.num_samples == 12
    for a, b in zip(host.per_sample, devq.per_sample):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=2e-3, atol=2e-3,
                                       err_msg=k)


def test_evaluator_refuses_a_loader_without_a_pack(evaluator, scenes):
    cfg, model, _ = evaluator
    root, manifest = scenes
    from cadepth_tpu_torch.data.sunrgbd import SunRGBDLoader

    files = SunRGBDLoader(f"{root}/sunrgbd", manifest, split="test",
                          target_height=H, target_width=W,
                          rays_on_device=True)
    with pytest.raises(ValueError, match="packed loader"):
        p_eval.ModelEvaluator(cfg, model).evaluate(files,
                                                   device_resident=True)


def _yaml(scenes, out: Path, device_resident: bool) -> Path:
    import yaml

    cfg = raw(scenes, out)
    cfg["data"]["device_resident"] = device_resident
    cfg["experiment"]["name"] = "cli_devres"
    path = out / f"cli_{device_resident}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_train_and_evaluate_clis_from_the_device(scenes, tmp_path):
    """The train CLI trains from the pack held on the device, resumes,
    and the evaluate CLI sweeps best/ from the device: the per-sample
    metrics of the host sweep."""
    dev_yaml = _yaml(scenes, tmp_path, True)
    assert train_cli.main(["--config", str(dev_yaml), "--device",
                           "cpu"]) == 0
    ckpts = tmp_path / "ckpts" / "cli_devres"
    assert (ckpts / "best" / "state.pt").exists()
    assert sorted(p.name for p in ckpts.glob("step_*"))
    rows = list(csv.reader((tmp_path / "logs" / "cli_devres" /
                            "metrics.csv").open()))
    assert len(rows) == 3 and len(rows[0]) == 13
    text = dev_yaml.read_text().replace("num_epochs: 2", "num_epochs: 3")
    dev_yaml.write_text(text)
    assert train_cli.main(["--config", str(dev_yaml), "--device", "cpu",
                           "--resume", "latest"]) == 0
    rows = list(csv.reader((tmp_path / "logs" / "cli_devres" /
                            "metrics.csv").open()))
    assert [r[0] for r in rows[1:]] == ["0", "1", "2"]
    per_sample = {}
    for device_resident in (True, False):
        out = tmp_path / f"eval_{device_resident}"
        assert evaluate_cli.main([
            "--checkpoint", "best", "--config",
            str(dev_yaml if device_resident
                else _yaml(scenes, tmp_path, False)),
            "--output", str(out), "--batch-size", "5", "--num-vis", "1",
            "--device", "cpu"]) == 0
        per_sample[device_resident] = (out / "per_sample_metrics.csv") \
            .read_text()
    assert per_sample[True] == per_sample[False]
    assert len(per_sample[True].splitlines()) == 13
