"""Profiling and step timing (port of ``cadepth_tpu.utils.profiling``).

``torch.profiler`` traces in place of ``jax.profiler``'s, viewable in
TensorBoard or Perfetto, and a step timer whose fence is a
``torch.cuda.synchronize`` on a card: the host enqueues steps ahead of
the card, so a clock read without it measures the host alone.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


def hard_sync(device=None) -> None:
    """Fence: wait until the card has run everything enqueued on it (no-op
    on the CPU, whose operations have finished when they return)."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block (the CPU, and the
    card where there is one) into ``log_dir`` as a TensorBoard trace."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Rolling step timing with correct device fencing.

    Usage:
        timer = StepTimer()
        for batch in pipe:
            logs = train_step(batch)
            timer.step(batch_size)           # no wait on the card
        images_per_sec = timer.rate(device)  # fences + computes
    """

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0: Optional[float] = None
        self._items = 0
        self._steps = 0

    def step(self, num_items: int = 1) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        else:
            # first step excluded: it absorbs the warm-up
            self._items += num_items
            self._steps += 1

    def rate(self, fence_device=None) -> float:
        """items/sec over the timed window (fences ``fence_device``)."""
        if self._t0 is None or self._steps == 0:
            return 0.0
        if fence_device is not None:
            hard_sync(fence_device)
        elapsed = time.perf_counter() - self._t0
        return self._items / elapsed if elapsed > 0 else 0.0

    @property
    def steps(self) -> int:
        return self._steps


def enable_nan_debugging() -> None:
    """Turn on autograd's anomaly detection, which raises at the backward
    operation that produced a NaN. Slows execution; debug only."""
    torch.autograd.set_detect_anomaly(True)
