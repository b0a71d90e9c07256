"""Learning-rate schedules (port of ``cadepth_tpu.training.schedule``).

:func:`build_lr_schedule` returns a plain function ``step -> lr`` that
gives optax's values at every optimizer step: the JAX package's
schedules are optax's ``linear_schedule`` warmup from 0 joined to a
step, cosine or constant decay. The arithmetic is optax's, in float32,
so the two agree to the last bit or an ulp of ``cos``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from cadepth_tpu_torch.config import OptimizationConfig

_F = np.float32


def _constant(value: float) -> Callable[[int], np.float32]:
    return lambda count: _F(value)


def _piecewise_constant(value: float, boundaries_and_scales
                        ) -> Callable[[int], np.float32]:
    """optax.piecewise_constant_schedule: the value times every scale
    whose boundary the count has reached."""
    items = sorted(boundaries_and_scales.items())

    def schedule(count: int) -> np.float32:
        v = _F(value)
        for threshold, scale in items:
            indicator = _F(max(0.0, float(np.sign(threshold - count))))
            v = v * indicator + (_F(1.0) - indicator) * _F(scale) * v
        return v

    return schedule


def _cosine_decay(value: float, decay_steps: int, alpha: float
                  ) -> Callable[[int], np.float32]:
    """optax.cosine_decay_schedule with exponent 1."""

    def schedule(count: int) -> np.float32:
        c = _F(min(float(count), float(decay_steps)))
        cosine = _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * c / _F(decay_steps)))
        return _F(value) * (_F(1.0 - alpha) * cosine + _F(alpha))

    return schedule


def _linear_warmup(end_value: float, steps: int
                   ) -> Callable[[int], np.float32]:
    """optax.linear_schedule(0, end_value, steps)."""

    def schedule(count: int) -> np.float32:
        frac = _F(1.0) - _F(min(max(count, 0), steps)) / _F(steps)
        return _F(0.0 - end_value) * frac + _F(end_value)

    return schedule


def build_lr_schedule(opt: OptimizationConfig, steps_per_epoch: int,
                      num_epochs: int) -> Callable[[int], float]:
    """Warmup + {step | cosine | none} decay, per optimizer step.

    Epoch rules become step counts through ``steps_per_epoch``. Decay
    boundaries count from the end of warmup, so "decay every
    lr_step_size epochs from the start of training" holds. ``plateau``
    (validation-driven in the reference, never wired there) is constant.
    """
    steps_per_epoch = max(steps_per_epoch, 1)
    warmup_steps = opt.lr_warmup_epochs * steps_per_epoch
    base_lr = opt.learning_rate
    if opt.lr_scheduler in ("none", "constant", "plateau"):
        decay = _constant(base_lr)
    elif opt.lr_scheduler == "step":
        decay = _piecewise_constant(base_lr, {
            e * steps_per_epoch - warmup_steps: opt.lr_gamma
            for e in range(opt.lr_step_size, num_epochs + 1, opt.lr_step_size)
            if e * steps_per_epoch > warmup_steps})
    elif opt.lr_scheduler == "cosine":
        total = max(num_epochs * steps_per_epoch - warmup_steps, 1)
        decay = _cosine_decay(base_lr, total, opt.lr_min / base_lr)
    else:
        raise ValueError(f"Unknown lr_scheduler: {opt.lr_scheduler}")

    if warmup_steps > 0:
        warmup = _linear_warmup(base_lr, warmup_steps)
        return lambda step: float(warmup(step) if step < warmup_steps
                                  else decay(step - warmup_steps))
    return lambda step: float(decay(step))
