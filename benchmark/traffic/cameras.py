"""The four SUN RGB-D sensors' intrinsics and K at a scene's size.

(name, native width, native height, fx, fy, cx, cy) in pixels, as the
SUN RGB-D release states them for its aligned frames (Kinect v1 from
the NYU Depth v2 calibration). Scaled to a scene by width and height.
"""

from __future__ import annotations

import torch

SENSORS = (
    ("kv1", 640, 480, 518.857901, 519.469611, 325.582449, 253.736166),
    ("kv2", 730, 530, 529.5, 529.5, 365.0, 265.0),
    ("realsense", 681, 531, 691.584, 691.584, 340.5, 265.5),
    ("xtion", 640, 480, 570.342205, 570.342205, 310.0, 225.0),
)


def sensor_k(sensor: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(n, 3, 3) float32 K of sensors ``sensor`` (n,) at (height, width)."""
    table = torch.tensor(
        [[fx * width / w0, fy * height / h0, cx * width / w0,
          cy * height / h0] for _, w0, h0, fx, fy, cx, cy in SENSORS],
        dtype=torch.float32, device=sensor.device)[sensor]
    k = torch.zeros(sensor.shape[0], 3, 3, dtype=torch.float32,
                    device=sensor.device)
    k[:, 0, 0], k[:, 1, 1] = table[:, 0], table[:, 1]
    k[:, 0, 2], k[:, 1, 2] = table[:, 2], table[:, 3]
    k[:, 2, 2] = 1.0
    return k
