"""``norm_bytes`` against the norm calls of the port's own network,
counted by a hook on ``apply_norm`` on the CPU at batch 1."""

import copy

import pytest

from benchmark.core import manifest
from benchmark.core.program import program_config
from benchmark.metrics.lib import roofline
from benchmark.metrics.lib.norm_bytes import norm_bytes, norm_maps


def _hooked_norm_maps(config_name, features, tmp_path, monkeypatch):
    """[(shape, element bytes)] of the maps handed to ``apply_norm`` for
    a training-mode BatchNorm2d in one forward of the configuration's
    network at batch 1, with ``features`` in place of its width (the
    maps' heights and widths are the configuration's own)."""
    import torch

    from cadepth_tpu_torch.models import film, geometry_aware, layers
    from cadepth_tpu_torch.training import train_state as ts

    seen = []
    apply_norm = layers.apply_norm

    def counted(x, norm, out_dtype):
        if isinstance(norm, layers.BatchNorm2d) and norm.training:
            seen.append((tuple(x.shape), x.element_size()))
        return apply_norm(x, norm, out_dtype)

    for module in (layers, film, geometry_aware):
        monkeypatch.setattr(module, "apply_norm", counted)
    conf = copy.deepcopy(manifest.config(config_name))
    conf["config"]["model"]["init_features"] = features
    cfg = program_config(conf, 0, tmp_path)
    model, _ = ts.build_model_and_loss(cfg, device="cpu")
    model.train()
    h, w = cfg.data.input_height, cfg.data.input_width
    k = torch.tensor([[[0.9 * w, 0.0, w / 2], [0.0, 0.9 * w, h / 2],
                       [0.0, 0.0, 1.0]]])
    batch = {"rgb": torch.rand(1, h, w, 3), "intrinsics": k,
             "k4": torch.tensor([[0.9, 0.9 * w / h, 0.5, 0.5]]),
             "depth": torch.rand(1, h, w, 1) + 1.0}
    with torch.no_grad():
        model(*ts._inputs(cfg, batch))
    return cfg, seen


@pytest.mark.parametrize("config_name", ["flagship_f64_240x320",
                                         "production_f96_480x640"])
def test_norm_bytes_count_the_networks_22_training_norms(config_name,
                                                         tmp_path,
                                                         monkeypatch):
    import torch

    torch.set_num_threads(4)
    features = 4
    cfg, seen = _hooked_norm_maps(config_name, features, tmp_path,
                                 monkeypatch)
    h, w = cfg.data.input_height, cfg.data.input_width
    # the forward keeps the maps NCHW: shapes as (B, C, H, W)
    assert len(seen) == 22
    assert sorted(s for s, _ in seen) == sorted(norm_maps(1, h, w, features))
    elem = {e for _, e in seen}
    assert elem == {2 if cfg.training.use_amp else 4}
    counted = sum(5 * e * torch.Size(s).numel() for s, e in seen)
    small = copy.deepcopy(manifest.config(config_name)["config"])
    small["model"]["init_features"] = features
    small["training"]["batch_size"] = 1
    assert norm_bytes(small, elem.pop()) == counted


def test_flagship_norm_bound_is_3_67_ms_a_step():
    # 1.228 G elements a step at batch 32, 10 bytes each in bf16
    nbytes = norm_bytes(manifest.config("flagship_f64_240x320")["config"], 2)
    assert nbytes == 12_281_446_400
    assert roofline.bound_s(nbytes) * 1e3 == pytest.approx(3.6661, abs=1e-4)
    assert norm_bytes(manifest.config("production_f96_480x640")["config"],
                      2) == 18_432_000_000


@pytest.mark.parametrize("key,value", [
    ("model.architecture", "baseline_unet"),
    ("model.architecture", "geometry_aware_lightweight"),
    ("model.variant", "lightweight"), ("model.norm", "group"),
    ("hardware.spatial_parallel", 2)])
def test_norm_bytes_count_nothing_outside_the_reference_network(key, value):
    """Another network, norm or a map cut into bands is not the reference
    network's 22 whole maps: the count is None, and so is the metric."""
    conf = copy.deepcopy(manifest.config("flagship_f64_240x320")["config"])
    group, name = key.split(".")
    conf.setdefault(group, {})[name] = value
    assert norm_bytes(conf, 2) is None
