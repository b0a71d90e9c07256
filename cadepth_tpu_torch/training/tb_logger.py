"""TensorBoard event logging, written directly from the Python host.

A copy of ``cadepth_tpu.training.tb_logger``, which imports no JAX: the
port keeps its own so that it never imports the JAX package. Only the
package name changes.

Replaces the reference's C++ -> Python JSON-pipe bridge
(`tensorboard_logger_v2.h` + `scripts/tensorboard_writer.py`) — that IPC
contraption existed only because the trainer was C++ (SURVEY §5.5).
Here scalars/images/histograms/text/hparams go straight to event files
with the same tag taxonomy the reference's dashboards expect
(README.md:486-557):

    loss/train, loss/val, batch_loss/train,
    loss_components/{si,grad,smooth,reproj},
    metrics/{abs_rel,sq_rel,rmse,rmse_log,a1,a2,a3},
    training/{learning_rate,epoch_time_seconds,total_time_seconds,gradient_norm},
    gradients/{norm,max,min}, predictions/sample_i, weights/..., hparams

Falls back to a file-based logger (timestamped events_*.txt +
scalars.csv, mirroring `tensorboard_logger.h` v1) when no TensorBoard
backend is importable.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np


class _FileFallbackWriter:
    """Mirror of the v1 file-based logger (`tensorboard_logger.h:25-170`)."""

    def __init__(self, log_dir: str):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self._events = open(self.log_dir / f"events_{stamp}.txt", "a")
        self._scalars = open(self.log_dir / "scalars.csv", "a")
        if self._scalars.tell() == 0:
            self._scalars.write("step,tag,value\n")

    def add_scalar(self, tag, value, step):
        self._events.write(f"{time.time():.3f} scalar {tag} {step} {value}\n")
        self._scalars.write(f"{step},{tag},{value}\n")

    def add_image(self, tag, img, step, dataformats="HWC"):
        import cv2

        img_dir = self.log_dir / "images"
        img_dir.mkdir(exist_ok=True)
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
        path = img_dir / f"{tag.replace('/', '_')}_{step}.png"
        cv2.imwrite(str(path), cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))
        self._events.write(f"{time.time():.3f} image {tag} {step} {path}\n")

    def add_histogram(self, tag, values, step):
        v = np.asarray(values).reshape(-1)
        self._events.write(
            f"{time.time():.3f} histogram {tag} {step} "
            f"min={v.min():.6g} max={v.max():.6g} mean={v.mean():.6g} "
            f"std={v.std():.6g} n={v.size}\n")

    def add_text(self, tag, text, step):
        self._events.write(f"{time.time():.3f} text {tag} {step} {text!r}\n")

    def add_hparams(self, hparams, metrics):
        self._events.write(f"{time.time():.3f} hparams {hparams!r} {metrics!r}\n")

    def flush(self):
        self._events.flush()
        self._scalars.flush()

    def close(self):
        self._events.close()
        self._scalars.close()


class TensorBoardLogger:
    """Typed logging facade over a SummaryWriter-compatible backend."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.log_dir = log_dir
        self._writer = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=log_dir, flush_secs=10)
        except Exception:
            try:
                from tensorboardX import SummaryWriter  # type: ignore

                self._writer = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._writer = _FileFallbackWriter(log_dir)

    def add_custom_scalars_layout(self) -> None:
        """Dashboard panel layout, parity with `tensorboard_writer.py:48-72`
        (Training / Metrics / Model panels)."""
        if self._writer is None or not hasattr(self._writer, "add_custom_scalars"):
            return
        try:
            self._writer.add_custom_scalars({
                "Training": {
                    "Loss": ["Multiline", ["loss/train", "loss/val"]],
                    "Learning Rate": ["Multiline", ["training/learning_rate"]],
                    "Throughput": ["Multiline", ["training/images_per_sec"]],
                },
                "Metrics": {
                    "Errors": ["Multiline", ["metrics/abs_rel", "metrics/rmse",
                                             "metrics/rmse_log"]],
                    "Accuracy": ["Multiline", ["metrics/a1", "metrics/a2",
                                               "metrics/a3"]],
                },
                "Model": {
                    "Gradients": ["Multiline", ["training/gradient_norm"]],
                    "Loss Components": ["Multiline", [
                        "loss_components/si", "loss_components/grad",
                        "loss_components/smooth", "loss_components/reproj"]],
                },
            })
        except Exception:
            pass

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def add_scalars(self, values: Dict[str, float], step: int,
                    prefix: str = "") -> None:
        for tag, value in values.items():
            self.add_scalar(f"{prefix}{tag}" if prefix else tag, value, step)

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """image: (H, W, 3) float [0,1] or uint8, RGB."""
        if self._writer is None:
            return
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
        self._writer.add_image(tag, arr, step, dataformats="HWC")

    def add_histogram(self, tag: str, values: np.ndarray, step: int,
                      max_values: int = 10_000) -> None:
        """Values subsampled to <=10k, matching `tensorboard_logger_v2.h:125-151`."""
        if self._writer is None:
            return
        v = np.asarray(values).reshape(-1)
        if v.size > max_values:
            idx = np.linspace(0, v.size - 1, max_values).astype(np.int64)
            v = v[idx]
        self._writer.add_histogram(tag, v, step)

    def add_text(self, tag: str, text: str, step: int = 0) -> None:
        if self._writer is not None:
            self._writer.add_text(tag, text, step)

    def add_hparams(self, hparams: Dict[str, object],
                    metrics: Optional[Dict[str, float]] = None) -> None:
        if self._writer is None:
            return
        clean = {k: (v if isinstance(v, (int, float, str, bool)) else str(v))
                 for k, v in hparams.items()}
        try:
            self._writer.add_hparams(clean, metrics or {})
        except Exception:
            self.add_text("hparams", str(clean))

    def add_pr_curve(self, tag: str, labels: np.ndarray,
                     predictions: np.ndarray, step: int) -> None:
        """Precision-recall curve (`tensorboard_writer.py:206-212`,
        reachable from `tensorboard_logger_v2.h`'s pr_curve command)."""
        if self._writer is None:
            return
        labels = np.asarray(labels).reshape(-1)
        predictions = np.asarray(predictions).reshape(-1)
        if hasattr(self._writer, "add_pr_curve"):
            import torch

            self._writer.add_pr_curve(tag, torch.as_tensor(labels),
                                      torch.as_tensor(predictions), step)
        else:
            self.add_text(f"pr_curve/{tag}",
                          f"n={labels.size} pos={int(labels.sum())}", step)

    def add_embedding(self, tag: str, mat: np.ndarray,
                      metadata=None, step: int = 0) -> None:
        """Projector embedding (`tensorboard_writer.py:214-220`)."""
        if self._writer is None:
            return
        mat = np.asarray(mat)
        if hasattr(self._writer, "add_embedding"):
            import torch

            self._writer.add_embedding(torch.as_tensor(mat),
                                       metadata=metadata, tag=tag,
                                       global_step=step)
        else:
            self.add_text(f"embedding/{tag}", f"shape={mat.shape}", step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
