"""Model evaluation: per-sample metrics, timing, aggregation, reports (port
of ``cadepth_tpu.evaluation.evaluator``).

Warmup iterations, then timed per-batch inference with a device fence
(``torch.cuda.synchronize`` on a card, where JAX blocks on the result),
per-sample metric records, mean/std/median aggregation, FPS, the
parameter count and model size, CSV export and a text report.
``device_resident=True`` sweeps a pack held in device memory
(``data/device_resident.py``) instead of the host pipeline.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from cadepth_tpu_torch.config import Config
from cadepth_tpu_torch.data.pipeline import InputPipeline
from cadepth_tpu_torch.data.sunrgbd import SunRGBDLoader
from cadepth_tpu_torch.metrics.depth_metrics import (
    METRIC_NAMES,
    compute_depth_metrics_per_sample,
)
from cadepth_tpu_torch.models.factory import count_parameters
from cadepth_tpu_torch.training.train_state import (device_batch,
                                                    make_predict_fn)
from cadepth_tpu_torch.utils.profiling import hard_sync


@dataclasses.dataclass
class EvaluationConfig:
    """Parity with `EvaluationConfig` (`evaluator.h:19-52`)."""

    min_depth: float = 0.1
    max_depth: float = 10.0
    warmup_iterations: int = 5
    batch_size: int = 1
    num_vis_samples: int = 4
    save_predictions: bool = False
    colormap: str = "viridis"


@dataclasses.dataclass
class EvaluationResult:
    """Aggregate record (`evaluator.h:57-94`)."""

    mean_metrics: Dict[str, float]
    std_metrics: Dict[str, float]
    median_metrics: Dict[str, float]
    per_sample: List[Dict[str, float]]
    inference_ms_mean: float
    inference_ms_std: float
    fps: float
    num_samples: int
    num_params: int
    model_size_mb: float
    timestamp: str


class ModelEvaluator:
    """Evaluates ``model`` (holding its weights, on its device)."""

    def __init__(self, cfg: Config, model: nn.Module,
                 eval_cfg: Optional[EvaluationConfig] = None):
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.eval_cfg = eval_cfg or EvaluationConfig(
            min_depth=cfg.validation.min_depth,
            max_depth=cfg.validation.max_depth)
        self.predict_fn = make_predict_fn(cfg, model)

    def evaluate(self, loader: SunRGBDLoader,
                 max_samples: Optional[int] = None,
                 device_resident: bool = False) -> EvaluationResult:
        """Warmup, timed per-batch inference, per-sample metrics
        (`evaluator.h:142-226,281-302`).

        ``device_resident`` uploads the (packed) dataset to the device once
        and sweeps it with gathers there — the same exact full sweep, no
        per-batch copy of images to the device."""
        ecfg = self.eval_cfg
        bsz = max(ecfg.batch_size, 1)
        if device_resident:
            pipe, warm = self._device_sweep(loader, bsz, max_samples)
        else:
            pipe = InputPipeline(loader, batch_size=bsz, shuffle=False,
                                 drop_remainder=False,
                                 max_samples=max_samples, device=self.device)
            # Warmup (evaluator.h:154-157)
            warm = device_batch(
                loader.get_batch(range(min(bsz, len(loader)))), self.device)
        for _ in range(ecfg.warmup_iterations):
            self.predict_fn(warm)
            hard_sync(self.device)

        per_sample: List[Dict[str, float]] = []
        times_ms: List[float] = []
        for batch in pipe:
            t0 = time.perf_counter()
            pred = self.predict_fn(batch)
            hard_sync(self.device)
            elapsed_ms = (time.perf_counter() - t0) * 1000.0
            n_in_batch = pred.shape[0]
            times_ms.extend([elapsed_ms / n_in_batch] * n_in_batch)
            metrics = compute_depth_metrics_per_sample(
                pred, batch["depth"],
                min_depth=ecfg.min_depth, max_depth=ecfg.max_depth)
            host = {k: v.cpu().numpy() for k, v in metrics.items()}
            for i in range(n_in_batch):
                per_sample.append({k: float(v[i]) for k, v in host.items()})

        def agg(fn):
            return {k: float(fn([s[k] for s in per_sample]))
                    for k in METRIC_NAMES} if per_sample else {}

        times = np.asarray(times_ms) if times_ms else np.zeros(1)
        num_params = count_parameters(self.model)
        return EvaluationResult(
            mean_metrics=agg(np.mean),
            std_metrics=agg(lambda v: np.std(v)),
            median_metrics=agg(np.median),
            per_sample=per_sample,
            inference_ms_mean=float(times.mean()),
            inference_ms_std=float(times.std()),
            fps=float(1000.0 / times.mean()) if times.mean() > 0 else 0.0,
            num_samples=len(per_sample),
            num_params=num_params,
            model_size_mb=num_params * 4 / (1024.0 * 1024.0),
            timestamp=time.strftime("%Y-%m-%d %H:%M:%S"),
        )

    def _device_sweep(self, loader, bsz: int, max_samples: Optional[int]):
        """(the batches of an exact identity-order sweep of ``loader``'s
        pack held on the device, a warm-up batch)."""
        from cadepth_tpu_torch.data.device_resident import (
            ChunkedDeviceDataset,
            DeviceDataset,
        )

        # Honor the training-side capacity knobs: chunked streaming for
        # packs bigger than device memory, quantized storage for 3.2x less
        # of it. Metrics through the quantized path differ only by the
        # documented encodings (depth stored mm-exact).
        chunk = self.cfg.data.device_resident_chunk_samples
        ds_kw = {"device": self.device}
        if self.cfg.data.device_resident_dtype == "quantized":
            ds_kw.update(rgb_dtype=torch.uint8, depth_dtype=torch.uint16)
        n = len(loader) if max_samples is None \
            else min(len(loader), max_samples)
        if chunk > 0:
            cds = ChunkedDeviceDataset(loader, chunk, **ds_kw)
            # exact sweep: identity order, padded-gather tail trimmed by
            # batches() itself, every sample once
            pipe = cds.batches(bsz, shuffle=False, epoch=0, augment=False,
                               drop_remainder=False, max_samples=n)
            # warm against the sweep's EFFECTIVE chunk (batches() rounds
            # the chunk to a batch multiple); grow the staging slots to it
            # first, as batches() does, since this _upload bypasses it
            c_eff = min(max(cds.chunk_samples - cds.chunk_samples % bsz,
                            bsz), n)
            cds._ensure_slots(c_eff)
            buf = cds._upload(np.arange(c_eff), slot=0, block=True)
            warm = cds._gather(buf["rgb"], buf["depth"], buf["k"],
                               buf["gids"], np.arange(bsz) % c_eff)
            return pipe, warm
        ds = DeviceDataset(loader, **ds_kw)
        # the sweep's indices, copied once: each batch is a slice
        positions = torch.arange(n, device=self.device)

        def device_sweep():
            for s in range(0, n, bsz):
                idx = positions[s:s + bsz]
                valid = idx.shape[0]
                if valid < bsz:  # pad the gather, trim the outputs
                    idx = torch.cat([idx, idx.new_zeros(bsz - valid)])
                b = ds._gather(idx)
                yield ({k: v[:valid] for k, v in b.items()}
                       if valid < bsz else b)

        return device_sweep(), ds._gather(np.arange(min(bsz, n)))

    # -- outputs ------------------------------------------------------------

    @staticmethod
    def write_csv(result: EvaluationResult, path: str) -> None:
        """Per-sample CSV (`evaluator.h:486-543`)."""
        keys = list(METRIC_NAMES)
        with open(path, "w") as f:
            f.write("sample," + ",".join(keys) + "\n")
            for i, s in enumerate(result.per_sample):
                f.write(f"{i}," + ",".join(f"{s[k]:.6f}" for k in keys) + "\n")

    @staticmethod
    def write_summary_csv(result: EvaluationResult, path: str) -> None:
        with open(path, "w") as f:
            f.write("metric,mean,std,median\n")
            for k in METRIC_NAMES:
                f.write(f"{k},{result.mean_metrics.get(k, 0):.6f},"
                        f"{result.std_metrics.get(k, 0):.6f},"
                        f"{result.median_metrics.get(k, 0):.6f}\n")

    @staticmethod
    def report(result: EvaluationResult, model_name: str = "model") -> str:
        """Text report (`evaluate_main.cpp:214-278`)."""
        m, s = result.mean_metrics, result.std_metrics
        lines = [
            "=" * 60,
            f"Evaluation report — {model_name}",
            f"Generated: {result.timestamp}",
            "=" * 60,
            "",
            f"Samples evaluated: {result.num_samples}",
            f"Parameters: {result.num_params:,} "
            f"({result.model_size_mb:.1f} MB fp32)",
            f"Inference: {result.inference_ms_mean:.2f} ± "
            f"{result.inference_ms_std:.2f} ms/image ({result.fps:.1f} FPS)",
            "",
            "Error metrics (mean ± std, lower is better):",
        ]
        for k in ("abs_rel", "sq_rel", "rmse", "rmse_log", "mae", "log10"):
            lines.append(f"  {k:12s} {m.get(k, 0):.4f} ± {s.get(k, 0):.4f}")
        lines.append("")
        lines.append("Accuracy metrics (higher is better):")
        for k in ("delta_1.25", "delta_1.25^2", "delta_1.25^3"):
            lines.append(f"  {k:12s} {m.get(k, 0):.4f}")
        return "\n".join(lines)
