"""Seeded structured RGB-D scenes, made on the device in bulk.

The scene model is the repository's synthetic SUN RGB-D fixture
(``_structured_scene`` of the data package), vectorised over scenes: a
floor-like plane receding from 9 m at the top row to 2 m at the bottom
(+0.5 m across), three to six boxes a scene at 0.8-8.5 m that occlude
what lies behind them, each coloured by its depth, shading by depth,
Gaussian colour noise of 0.02, rgb stored as 8-bit values, depth as
whole millimetres with 2 % of the pixels dropped to 0 (holes). K is one
of the four SUN RGB-D sensors' (``cameras.py``), scaled to the scene's
size; the sensor is drawn a scene.

Every tensor comes from one ``torch.Generator`` on the device seeded by
the run's seed, so one seed gives the same scenes on every run.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.core.weights import generator
from benchmark.traffic.cameras import sensor_k

SCENES_STREAM = 0x5343
MAX_BOXES = 6


def structured_scenes(n: int, height: int, width: int, seed: int, device,
                      stream: int = SCENES_STREAM) -> Dict[str, torch.Tensor]:
    """{"rgb" (n, H, W, 3) in [0, 1], "depth" (n, H, W, 1) metres, "k" (n,
    3, 3), "sensor" (n,)}, float32 (sensor int64) on ``device``."""
    g = generator(seed, stream, device)

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=device)

    u = torch.arange(width, dtype=torch.float32, device=device)[None, None, :]
    v = torch.arange(height, dtype=torch.float32, device=device)[None, :, None]
    depth = (2.0 + 6.0 * (1.0 - v / height) + 0.5 * (u / width)).expand(
        n, height, width).clone()
    color = torch.stack(torch.broadcast_tensors(
        0.2 + 0.05 * torch.sin(u / 7.0), 0.3 + 0.04 * torch.cos(v / 9.0),
        torch.full_like(u, 0.5)), dim=-1).expand(n, height, width, 3).clone()

    count = 3 + torch.floor(uniform(n) * 4.0)              # 3..6 boxes
    bw = torch.floor(width // 8 + uniform(n, MAX_BOXES)
                     * (width // 3 - width // 8))
    bh = torch.floor(height // 8 + uniform(n, MAX_BOXES)
                     * (height // 3 - height // 8))
    x0 = torch.floor(uniform(n, MAX_BOXES) * (width - bw))
    y0 = torch.floor(uniform(n, MAX_BOXES) * (height - bh))
    d = 0.8 + uniform(n, MAX_BOXES) * 7.7
    for i in range(MAX_BOXES):
        c = lambda t: t[:, i, None, None]                 # noqa: E731
        inside = ((u >= c(x0)) & (u < c(x0) + c(bw)) & (v >= c(y0))
                  & (v < c(y0) + c(bh)) & (i < count)[:, None, None])
        mask = inside & (depth > c(d))
        depth = torch.where(mask, c(d), depth)
        shade = c(d)[..., None] / 10.0
        box = torch.cat([0.9 - 0.7 * shade, 0.2 + 0.6 * shade,
                         0.4 + 0.3 * shade], dim=-1)
        color = torch.where(mask[..., None], box, color)
    color = color * (1.1 - depth[..., None] / 15.0)
    color = color + 0.02 * torch.randn(color.shape, generator=g, device=device)
    rgb = torch.floor(color.clamp(0.0, 1.0) * 255.0) / 255.0
    mm = torch.floor(depth * 1000.0)
    mm = torch.where(uniform(n, height, width) < 0.02, 0.0, mm)
    sensor = torch.floor(uniform(n) * 4.0).long()
    return {"rgb": rgb, "depth": (mm / 1000.0)[..., None],
            "k": sensor_k(sensor, height, width), "sensor": sensor}
