"""BENCHMARK.json loads, and every cell, configuration, traffic mix and
per-layer metric it names is found by name and keeps the contract's
limits."""

import json
import re

from benchmark.core import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DRIVER_NUMBERS = {"train": {"depth_dev_first", "loss_gap",
                            "loss_gap_first", "grad_gap", "grad_gap_median",
                            "update_gap", "update_gap_median"},
                  "serve": {"depth_max_abs_m", "depth_rel_l2",
                            "depth_mean_abs_m", "depth_mean_rel_l2",
                            "depth_dev", "depth_dev_max"}}


def test_every_name_is_found():
    m = manifest.manifest()
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert m["paths"] == ["benchmark"]
    configs = {c["name"] for c in m["configs"]}
    for c in m["configs"]:
        conf = manifest.config(c["name"])
        assert conf["name"] == c["name"]
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert c["source"].startswith("https://")
        # every key changed from the shipped YAML is listed, the cuts of
        # scale apart from the other changes
        assert c["reduced"] == list(conf["reduced"]) + list(conf["changed"])
        assert not set(conf["reduced"]) & set(conf["changed"])
    used = set()
    for w in m["workloads"]:
        cell = manifest.cell(w["name"])
        assert cell["config"] in configs
        used.add(cell["config"])
        assert cell["chips"] in (1, 4)
        assert set(cell["limits"]) <= DRIVER_NUMBERS[cell["mix"]["driver"]]
        assert 1 <= len(cell["why"]) <= 200
        assert manifest.metrics_of(w["name"], "end_to_end")
        assert manifest.metrics_of(w["name"], "per_layer")
    assert used == configs
    cells = {w["name"] for w in m["workloads"]}
    for metric in m["per_layer"]:
        assert callable(manifest.metric_reader(metric["name"]))
        assert set(metric["workloads"]) <= cells
        assert metric["moves"] in {e["name"] for e in m["end_to_end"]}
    for metric in m["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])


def test_names_units_and_sizes_keep_the_contract():
    m = manifest.manifest()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")
    for c in m["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
    assert len(json.dumps(m)) < 64 * 1024
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)


def test_every_trace_metric_has_a_reader_that_finds_nothing_without_a_trace():
    run = type("Run", (), {"trace": None, "spans": None,
                           "images_per_s": 1.0, "use_amp": True})
    for metric in manifest.manifest()["per_layer"]:
        if metric["source"] == "device_trace":
            assert manifest.metric_reader(metric["name"])(run) is None
