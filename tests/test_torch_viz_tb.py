"""The port's panels, TensorBoard logger and step timer against the JAX
package's: every colour map and panel equal bit for bit (both call cv2
alike), the logger's calls to its writer and its file fallback equal,
and the timer's and profiler's behaviour on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread per process)
from cadepth_tpu.training import tb_logger as j_tb
from cadepth_tpu.utils import profiling as j_prof
from cadepth_tpu.visualization import depth_viz as j_viz
from cadepth_tpu_torch.training import tb_logger as p_tb
from cadepth_tpu_torch.utils import profiling as p_prof
from cadepth_tpu_torch.visualization import depth_viz as p_viz


def _maps(seed=0, h=24, w=32):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    gt = rng.uniform(0.2, 9.0, (h, w, 1)).astype(np.float32)
    gt[rng.uniform(0, 1, gt.shape) < 0.1] = 0.0
    pred = (gt + rng.normal(0, 0.3, gt.shape)).astype(np.float32)
    return rgb, gt, pred


@pytest.mark.parametrize("colormap", j_viz.COLORMAPS)
def test_colormaps_are_equal(colormap):
    _, gt, pred = _maps(1)
    assert p_viz.COLORMAPS == j_viz.COLORMAPS
    for lo, hi in ((None, None), (0.1, 10.0)):
        a = j_viz.apply_colormap(gt, colormap, lo, hi)
        b = p_viz.apply_colormap(gt, colormap, lo, hi)
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    assert np.array_equal(j_viz.create_error_map(pred, gt, colormap=colormap),
                          p_viz.create_error_map(pred, gt, colormap=colormap))
    with pytest.raises(ValueError):
        p_viz.apply_colormap(gt, "nonexistent")


def test_panels_are_equal(tmp_path):
    rgb, gt, pred = _maps(2)
    metrics = {"abs_rel": 0.12, "rmse": 0.5, "rmse_log": 0.2,
               "delta_1.25": 0.9}
    pairs = [
        (j_viz.create_comparison(rgb, gt, pred),
         p_viz.create_comparison(rgb, gt, pred)),
        (j_viz.create_labeled_comparison(rgb, gt, pred),
         p_viz.create_labeled_comparison(rgb, gt, pred)),
        (j_viz.create_comprehensive_visualization(rgb, gt, pred, metrics),
         p_viz.create_comprehensive_visualization(rgb, gt, pred, metrics)),
        (j_viz.create_comparison_grid([rgb, rgb], [gt, pred], [pred, gt]),
         p_viz.create_comparison_grid([rgb, rgb], [gt, pred], [pred, gt])),
        (j_viz.create_depth_histogram(gt), p_viz.create_depth_histogram(gt)),
        (j_viz.create_histogram(pred), p_viz.create_histogram(pred)),
    ]
    for a, b in pairs:
        assert a.shape == b.shape and np.array_equal(a, b)
    j_viz.save_depth_image(str(tmp_path / "j.png"), pred)
    p_viz.save_depth_image(str(tmp_path / "p.png"), pred)
    assert (tmp_path / "j.png").read_bytes() == \
        (tmp_path / "p.png").read_bytes()


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args, **kwargs):
            self.calls.append((name, [np.asarray(a) if isinstance(
                a, np.ndarray) else a for a in args], kwargs))
        return record


def test_logger_calls_its_writer_alike():
    """The same calls reach the writer: scalars as floats, images as
    uint8 HWC, histograms subsampled to 10,000 values at the same
    indices, text, hparams with non-scalars as strings, the layout."""
    rng = np.random.default_rng(3)
    calls = []
    for mod in (j_tb, p_tb):
        logger = mod.TensorBoardLogger("unused", enabled=False)
        logger._writer = rec = _Recorder()
        logger.add_scalar("loss/train", np.float32(0.25), 3)
        logger.add_scalars({"a1": 0.9, "rmse": 0.4}, 3, prefix="metrics/")
        logger.add_image("predictions/sample_0",
                         rng.uniform(0, 1, (4, 6, 3)), 1)
        logger.add_histogram("weights/enc1/conv1/kernel",
                             rng.normal(size=(25_000,)), 1)
        logger.add_text("model/architecture", "geometry_aware", 0)
        logger.add_hparams({"lr": 1e-3, "betas": (0.9, 0.999)}, {"x": 1.0})
        logger.add_custom_scalars_layout()
        rng = np.random.default_rng(3)
        calls.append(rec.calls)
    assert [c[0] for c in calls[0]] == [c[0] for c in calls[1]]
    for (name, a, ka), (_, b, kb) in zip(*calls):
        assert ka == kb, name
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), name
            else:
                assert x == y, name


def test_file_fallback_writes_the_same_lines(tmp_path):
    for mod, name in ((j_tb, "j"), (p_tb, "p")):
        w = mod._FileFallbackWriter(str(tmp_path / name))
        for step in range(3):
            w.add_scalar("loss/train", 0.5 / (step + 1), step)
        w.add_histogram("weights/w", np.arange(10.0), 1)
        w.add_image("predictions/sample_0",
                    np.full((4, 6, 3), 0.5, np.float32), 2)
        w.close()
    assert (tmp_path / "j" / "scalars.csv").read_text() == \
        (tmp_path / "p" / "scalars.csv").read_text()
    assert (tmp_path / "j" / "images" / "predictions_sample_0_2.png") \
        .read_bytes() == (tmp_path / "p" / "images" /
                          "predictions_sample_0_2.png").read_bytes()


def test_step_timer_behaves_as_jax():
    """The first step starts the clock and is not counted; no rate before
    a counted step; on the CPU the fence is a no-op."""
    for mod, fence in ((j_prof, None), (p_prof, "cpu")):
        timer = mod.StepTimer()
        assert timer.rate(fence) == 0.0 and timer.steps == 0
        timer.step(4)
        assert timer.rate(fence) == 0.0 and timer.steps == 0
        timer.step(4)
        timer.step(4)
        assert timer.steps == 2 and timer.rate(fence) > 0
        timer.reset()
        assert timer.steps == 0
    p_prof.hard_sync("cpu")


def test_profile_trace_and_nan_debugging(tmp_path):
    with p_prof.profile_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert any((tmp_path / "trace").iterdir())
    was = torch.is_anomaly_enabled()
    try:
        p_prof.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)
