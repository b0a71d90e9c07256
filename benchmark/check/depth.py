"""How far a depth map lies from the reference's, as a share of the
reference's own variation: ||d - r|| / ||r - mean(r)|| a frame.

A random network's depths sit near a constant with a small, seed-
dependent spread; relative to the depth itself (its mean is ~5 m) an
error reads small or large with that spread. Relative to the spread it
reads the same from seed to seed: bf16 rounding 2-10 %, float8 25-75 %
(float32 reference, CPU emulation at f=32; `PERF.md` holds the card's)."""

from __future__ import annotations

import numpy as np


def deviation(served, ref) -> np.ndarray:
    """The share a frame, for depth maps (N, H, W, 1); inf where the
    shapes differ or a value is not finite."""
    s = np.asarray(served, np.float64)
    r = np.asarray(ref, np.float64)
    if s.shape != r.shape or not np.isfinite(s).all():
        return np.full(max(r.shape[0], 1), np.inf)
    flat_s = s.reshape(s.shape[0], -1)
    flat_r = r.reshape(r.shape[0], -1)
    spread = np.linalg.norm(flat_r - flat_r.mean(1, keepdims=True), axis=1)
    return np.linalg.norm(flat_s - flat_r, axis=1) / np.maximum(spread,
                                                                1e-30)
