"""What the benchmark hands the port: its ``Config`` built from a
configuration file, and the seeded scenes as a pack on disk that the
port's own loaders read.

A pack is the port's decode-once dataset cache (``packed_meta.json``
and ``rgb.npy``, ``depth.npy``, ``intrinsics.npy``, ``extrinsics.npy``:
float32 arrays, a record a sample). The benchmark writes the seeded
scenes as one under the run's ``TMPDIR``, points ``data.packed_dir`` at
it and builds the loaders with the trainer's ``build_loaders``. The
split's sample list then repeats the scenes up to the configuration's
``store_rows``, the rows a deployment's store holds, so the feed's
device store, its epoch and its draws have a deployment's size while the
pack on disk holds only the distinct scenes.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Dict

import numpy as np


def program_config(config_file: Dict, seed: int, scratch: Path):
    """The port's ``Config`` of a configuration file: its ``config``
    (the shipped YAML's content with the file's changes), the run's seed,
    logs, checkpoints and the pack under the run's scratch directory."""
    from cadepth_tpu_torch.config import config_from_dict

    raw = copy.deepcopy(config_file["config"])
    raw.setdefault("experiment", {})["seed"] = int(seed)
    raw.setdefault("logging", {})["log_dir"] = str(scratch / "logs")
    raw.setdefault("checkpointing", {})["checkpoint_dir"] = \
        str(scratch / "checkpoints")
    raw.setdefault("data", {})["packed_dir"] = str(scratch / "pack")
    return config_from_dict(raw)


def write_pack(scenes: Dict[str, np.ndarray], out: Path) -> None:
    """The pack of host arrays ``scenes`` (rgb (N, H, W, 3), depth (N, H,
    W, 1), k (N, 3, 3) float32, sensor (N,) an index into the four
    sensors) in directory ``out``."""
    from cadepth_tpu_torch.data.sunrgbd import ALL_SENSORS

    out.mkdir(parents=True)
    n, h, w = scenes["rgb"].shape[:3]
    np.save(out / "rgb.npy", scenes["rgb"])
    np.save(out / "depth.npy", scenes["depth"])
    np.save(out / "intrinsics.npy", scenes["k"])
    np.save(out / "extrinsics.npy",
            np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)))
    meta = {"num_samples": n, "height": h, "width": w, "dtype": "float32",
            "samples": [{"path": f"scene_{i:05d}",
                         "sensor_type": ALL_SENSORS[int(scenes["sensor"][i])],
                         "scene_type": "synthetic", "split": ""}
                        for i in range(n)]}
    with open(out / "packed_meta.json", "w") as f:
        json.dump(meta, f)


def loaders(cfg, rows: int):
    """(train, validation) loaders of the trainer over the pack at
    ``cfg.data.packed_dir``, each split's samples the pack's scenes
    repeated to ``rows``."""
    from cadepth_tpu_torch.training.trainer import build_loaders

    out = build_loaders(cfg)
    for loader in out:
        found = loader.sample_paths
        loader.sample_paths = [found[i % len(found)] for i in range(rows)]
    return out
