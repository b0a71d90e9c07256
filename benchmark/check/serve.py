"""What decides ``correct`` in a serving cell.

Every request is a batch of host frames and their K; its answer is the
depth map the port hands back on the host. During the window a sample
of the finished requests is kept (reservoir sampling drawn from the
run's seed, so its size does not depend on how many finished). Once the
window has closed and the port is freed, the reference (plain PyTorch,
float32, TF32 off, batch norms on their running statistics) computes
each sampled request's depth from the seeded weights, the frames and K
alone: rays from K, the network, the two-pass warp.

The numbers (those the cell's file gives a limit are compared with it):

- ``depth_max_abs_m``: the largest |served - reference| over every
  pixel of the sample, in metres; ``depth_mean_abs_m``: its mean;
- ``depth_rel_l2``: the worst frame's ||served - reference|| /
  ||reference||; ``depth_mean_rel_l2``: the frames' mean;
- ``depth_dev``: the frames' mean of ||served - reference|| as a share of
  the reference's own variation (``depth.py``), steady from seed to
  seed; ``depth_dev_max``: the worst frame's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.check.depth import deviation
from benchmark.core.weights import layout, seeded_state
from benchmark.reference.model import forward
from benchmark.reference.precision import Precision


class Reservoir:
    """A uniform sample of ``size`` items from a stream (Algorithm R),
    drawn from ``seed``."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 0x5352])
        self.items: List = []
        self.seen = 0

    def offer(self, item_fn) -> None:
        """Offer the next item; ``item_fn()`` makes it only if it is
        kept."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item_fn())
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            self.items[j] = item_fn()


def k4_of(k: np.ndarray) -> np.ndarray:
    return np.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]],
                    -1).astype(np.float32)


@torch.no_grad()
def reference_depths(conf: Dict, requests: List[Dict], seed: int, device,
                     precision: str = "float32") -> List[np.ndarray]:
    """The reference's depth (N, H, W, 1) of each request {"rgb" (N, H,
    W, 3), "k" (N, 3, 3)} (host arrays)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = conf["config"]
    model = layout(c["model"]["init_features"]).to_empty(device=device)
    model.max_depth = float(c["model"].get("max_depth", 10.0))
    model.load_state_dict(seeded_state(model, seed, device))
    model.set_precision(Precision(precision))
    model.eval()
    out = []
    for req in requests:
        batch = {"rgb": torch.from_numpy(req["rgb"]).to(device),
                 "intrinsics": torch.from_numpy(req["k"]).to(device),
                 "k4": torch.from_numpy(k4_of(req["k"])).to(device)}
        out.append(forward(model, batch).cpu().numpy())
    return out


def compare(served: List[np.ndarray], ref: List[np.ndarray]
            ) -> Dict[str, float]:
    names = ("depth_max_abs_m", "depth_rel_l2", "depth_mean_abs_m",
             "depth_mean_rel_l2", "depth_dev", "depth_dev_max")
    abs_max, abs_sum, count, rels, devs = 0.0, 0.0, 0, [], []
    for s, r in zip(served, ref):
        s = np.asarray(s, np.float64)
        r = np.asarray(r, np.float64)
        if s.shape != r.shape or not np.isfinite(s).all():
            return {k: float("inf") for k in names}
        devs += list(deviation(s, r))
        d = np.abs(s - r)
        abs_max = max(abs_max, float(d.max()))
        abs_sum += float(d.sum())
        count += d.size
        rels += [float(np.linalg.norm(d[i]) / np.linalg.norm(r[i]))
                 for i in range(r.shape[0])]
    return dict(zip(names, (abs_max, max(rels), abs_sum / count,
                            float(np.mean(rels)), float(np.mean(devs)),
                            float(np.max(devs)))))
