"""Checkpoint save / restore / retention / best-model tracking (port of
``cadepth_tpu.training.checkpoint``, over ``torch.save`` in place of
Orbax).

A checkpoint is a directory, ``step_<n>/`` (n = the micro-steps taken,
eight digits) or ``best/``, holding ``state.pt`` (a train step's
``state_dict``: ``step``, the model's ``state_dict`` and the optimizer's,
with its ``updates`` and MultiSteps' running mean) and ``meta.json``
(epoch, global step, metrics). Retention keeps the last ``keep_last_n``
step checkpoints; ``best/`` is a copy of the step checkpoint that set the
best monitored metric.

Every checkpoint is written under a temporary name that does not match
``step_*`` and renamed into place when complete, so a process killed
mid-write (a SIGTERM, a lost machine) never leaves a half checkpoint that
``--resume latest`` would pick. ``save(blocking=False)`` snapshots the
tensors to the CPU at once (the step updates parameters in place) and
writes them on a thread; the meta, best copy and retention run in
:meth:`finalize`, called before the next save and by every lookup.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def _cpu_copy(tree):
    """``tree`` with every tensor copied to the CPU (a copy even where it
    lies there already)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_copy(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        keep_last_n: int = 3,
        metric_name: str = "abs_rel",
        metric_lower_is_better: bool = True,
    ):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_last_n = keep_last_n
        self.metric_name = metric_name
        self.metric_lower_is_better = metric_lower_is_better
        # (writer thread, ckpt_dir, meta, is_best, error list) of an
        # in-flight save; at most one at a time
        self._pending = None

    # -- paths ----------------------------------------------------------

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}"

    @property
    def best_dir(self) -> Path:
        return self.directory / "best"

    def _tmp_dir(self, name: str) -> Path:
        return self.directory / f".tmp_{name}"

    # -- save -------------------------------------------------------------

    def _write(self, state: Dict[str, Any], meta: Dict[str, Any],
               ckpt_dir: Path) -> None:
        tmp = self._tmp_dir(ckpt_dir.name)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        torch.save(state, tmp / STATE_FILE)
        (tmp / META_FILE).write_text(json.dumps(meta, indent=2))
        if ckpt_dir.exists():
            shutil.rmtree(ckpt_dir)
        os.replace(tmp, ckpt_dir)

    def save(self, state: Dict[str, Any], epoch: int,
             metrics: Optional[Dict[str, float]] = None,
             is_best: bool = False, blocking: bool = True) -> str:
        """Write a step checkpoint of ``state`` (a train step's
        ``state_dict``), then its best copy and retention.

        ``blocking=False`` returns once the tensors are copied to the CPU;
        a thread writes them while the next epoch runs, and the best copy
        and retention wait for :meth:`finalize`.
        """
        self.finalize()
        step = int(state["step"])
        ckpt_dir = self._step_dir(step)
        meta = {
            "epoch": epoch,
            "global_step": step,
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        snapshot = _cpu_copy(state)
        errors: list = []

        def write():
            try:
                self._write(snapshot, meta, ckpt_dir)
            except Exception as exc:  # raised again by finalize()
                errors.append(exc)

        thread = threading.Thread(target=write, daemon=True)
        thread.start()
        self._pending = (thread, ckpt_dir, is_best, errors)
        if blocking:
            self.finalize()
        return str(ckpt_dir)

    def finalize(self) -> None:
        """Block until any in-flight save lands, then copy it to best/ if
        it is the best, and apply retention."""
        if self._pending is None:
            return
        thread, ckpt_dir, is_best, errors = self._pending
        self._pending = None
        thread.join()
        if errors:
            raise errors[0]
        if is_best:
            tmp = self._tmp_dir("best")
            if tmp.exists():
                shutil.rmtree(tmp)
            shutil.copytree(ckpt_dir, tmp)
            if self.best_dir.exists():
                shutil.rmtree(self.best_dir)
            os.replace(tmp, self.best_dir)
        self._cleanup()

    def _cleanup(self) -> None:
        """Keep only the N most recent step checkpoints."""
        ckpts = sorted(c for c in self.directory.glob("step_*")
                       if c.is_dir())
        for old in ckpts[: max(0, len(ckpts) - self.keep_last_n)]:
            shutil.rmtree(old, ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def latest_checkpoint(self) -> Optional[str]:
        self.finalize()
        ckpts = sorted(c for c in self.directory.glob("step_*")
                       if c.is_dir())
        return str(ckpts[-1]) if ckpts else None

    def resolve(self, checkpoint: str) -> str:
        """The directory of ``checkpoint``: "best", "latest" (the newest
        step checkpoint) or any other string as a path; FileNotFoundError
        where it holds no checkpoint."""
        if checkpoint == "best":
            path = str(self.best_dir)
        elif checkpoint == "latest":
            path = self.latest_checkpoint()
            if path is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        else:
            path = checkpoint
        if not (Path(path) / STATE_FILE).exists():
            raise FileNotFoundError(f"no checkpoint at {path}")
        return path

    def restore(self, path: str, map_location="cpu") -> Dict[str, Any]:
        """The ``state`` saved at ``path``, its tensors on
        ``map_location``."""
        self.finalize()
        return torch.load(Path(path).absolute() / STATE_FILE,
                          map_location=map_location, weights_only=True)

    def best_metric_value(self) -> Optional[float]:
        """The monitored metric stored with the best/ checkpoint, if any."""
        self.finalize()
        meta_path = self.best_dir / META_FILE
        if not meta_path.exists():
            return None
        metrics = json.loads(meta_path.read_text()).get("metrics", {})
        value = metrics.get(self.metric_name)
        return float(value) if value is not None else None

    def restore_with_meta(self, path: str, map_location="cpu"):
        state = self.restore(path, map_location)
        meta_path = Path(path).absolute() / META_FILE
        meta: Dict[str, Any] = {}
        if meta_path.exists():
            meta = json.loads(meta_path.read_text())
        return state, meta
