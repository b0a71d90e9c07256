"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<cell>``'s limits on the numbers that decide ``correct`` are
``benchmark/workloads/<cell>.json``, a traffic mix ``<traffic>`` is
``benchmark/traffic/mixes/<traffic>.json`` (its ``driver`` names the
loop in ``benchmark/drivers/``), a configuration ``<config>`` is
``benchmark/configs/<config>.json``, and a per-layer metric ``<metric>``
is read by ``benchmark/metrics/<metric>.py``. Adding
one of them adds a file and an entry in the manifest; no file that is
there changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MANIFEST = ROOT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _named(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def manifest() -> Dict:
    with open(MANIFEST) as f:
        return json.load(f)


def cell(name: str) -> Dict:
    """The manifest's entry of cell ``name`` with its ``limits`` and its
    traffic mix's parameters (``mix``)."""
    entries = [w for w in manifest()["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in {MANIFEST.name}")
    entry = dict(entries[0])
    with open(BENCH / "workloads" / f"{_named(name)}.json") as f:
        entry["limits"] = json.load(f)["limits"]
    with open(BENCH / "traffic" / "mixes"
              / f"{_named(entry['traffic'])}.json") as f:
        entry["mix"] = json.load(f)
    return entry


def config(name: str) -> Dict:
    with open(BENCH / "configs" / f"{_named(name)}.json") as f:
        return json.load(f)


def metrics_of(cell_name: str, kind: str) -> List[Dict]:
    """The manifest's ``end_to_end`` or ``per_layer`` metrics that cell
    ``cell_name`` reports: those whose ``workloads`` name it, and those
    with no ``workloads``."""
    return [m for m in manifest()[kind]
            if cell_name in m.get("workloads", [cell_name])]


def metric_reader(name: str):
    """The ``read(run)`` function of ``benchmark/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{_named(name)}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
