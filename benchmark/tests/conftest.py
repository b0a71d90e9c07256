"""Tests of the benchmark harness, on the CPU at tiny sizes (the card
tests carry the ``cuda`` marker and skip without a card).

    python -m pytest benchmark/tests -q
"""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.core import env, manifest  # noqa: E402

env.prepare()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card; the test skips itself where "
        "torch.cuda.is_available() is False")


def tiny(cell_name: str, float32: bool = True):
    """(cell, configuration file) of ``cell_name`` cut to a CPU's size:
    f=4 at 32x48, batch 4 from a store of 24 rows repeating 8 scenes, 2
    warm-up steps (serving: requests of 2 frames
    from a pool of 4); ``float32`` runs the port without bf16, so a sound
    run's numbers sit at round-off."""
    import torch

    torch.set_num_threads(4)
    cell = manifest.cell(cell_name)
    conf = copy.deepcopy(manifest.config(cell["config"]))
    c = conf["config"]
    c["model"]["init_features"] = 4
    c["data"]["input_height"], c["data"]["input_width"] = 32, 48
    c["training"]["batch_size"] = 4
    c["training"]["use_amp"] = not float32
    c.setdefault("logging", {}).setdefault("tensorboard", {})["enabled"] = \
        False
    conf["scenes"], conf["store_rows"] = 8, 24
    if cell["mix"]["driver"] == "train":
        cell["mix"].update(warmup_steps=2)
    if cell["mix"]["driver"] == "serve":
        cell["mix"].update(batch=2, pool_scenes=4, warmup=1,
                           check_requests=2, profile_requests=2)
    return cell, conf


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
