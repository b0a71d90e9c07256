"""On the card: a short run of each cell prints a correct result line.

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""

import json
import subprocess
import sys

import pytest

from benchmark.core import manifest


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  manifest.manifest()["workloads"]])
def test_a_short_run_is_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < manifest.cell(name)["chips"]:
        pytest.skip("needs more cards")
    out = subprocess.run(
        [sys.executable, str(manifest.BENCH / "run.py"), "--workload", name,
         "--seed", str(2 ** 31 + 7), "--seconds", "3", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  manifest.manifest()["workloads"]])
def test_the_control_fails_the_cells_limits(name):
    """At the cell's own size the reference on float8 operands, in the
    port's place, is not correct."""
    import torch

    import benchmark.control as control

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = manifest.cell(name)
    numbers = control.readings(cell, manifest.config(cell["config"]),
                               2 ** 31 + 11, ["float8"],
                               torch.device("cuda", 0))["float8"]
    assert any(numbers[k] > v for k, v in cell["limits"].items()), numbers


def test_no_card_means_no_result(monkeypatch, capsys):
    """Without a card a measuring run exits non-zero and prints no
    result."""
    import torch

    import benchmark.run as run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", manifest.manifest()["workloads"][0]["name"],
                   "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
