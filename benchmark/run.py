"""Run one cell of the port's benchmark once and print its result.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, read from the
benchmark's spans and a spin-guarded profile taken after the window.
Progress goes to standard error; the last line of standard output is
one JSON object. The numbers that decide ``correct`` are printed with
their limits as the last lines of standard error and last in the JSON.
Exits non-zero, printing no result, without a card (or with fewer than
the cell asks for), without the port (2), or where the JAX package or
JAX was loaded (3).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root in place of this script's directory, so the
# benchmark's subpackages are reached only as benchmark.<name>
sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark.core import env, manifest  # noqa: E402

env.prepare()


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(cell: dict, conf: dict, seed: int, seconds: float, trace: bool,
            device, t_start: float) -> dict:
    """Drive the cell's mode, check its output and read its metrics; the
    result's JSON object (without the device's name). The driver is
    ``benchmark/drivers/<driver>.py``, as the cell's traffic mix names it."""
    driver = importlib.import_module(
        f"benchmark.drivers.{manifest.NAME.match(cell['mix']['driver'])[0]}")
    out = driver.run(cell, conf, seed, seconds, trace, device, t_start)
    shutil.rmtree(out.pop("scratch"), ignore_errors=True)
    limits = cell["limits"]
    checks = {k: {"value": out["numbers"][k], "limit": float(limits[k])}
              for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and \
        set(limits) <= set(out["numbers"])
    ctx = type("Run", (), dict(out["context"], cell=cell, conf=conf))
    metrics = {}
    if trace:
        for m in manifest.metrics_of(cell["name"], "per_layer"):
            value = manifest.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest.metrics_of(cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "memory_peak_bytes": out["peak_bytes"]}}
    found = ctx.trace
    if trace and found is not None:
        result["device"].update(busy_s=found.busy_s, window_s=found.window_s)
        result["breakdown"] = {"device_ops": found.top_ops(),
                               "idle_gaps": found.idle_gaps()}
    result["window_s"] = out["window_s"]
    result["numbers"] = out["numbers"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = _args(argv)
    import torch

    cell = manifest.cell(args.workload)
    if not env.program_present():
        print(f"the port ({env.PROGRAM}) is not in this checkout",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    conf = manifest.config(cell["config"])
    device = torch.device("cuda", 0)
    torch.cuda.init()
    print(f"setup cuda {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    with contextlib.redirect_stdout(sys.stderr):
        result = execute(cell, conf, args.seed, args.seconds,
                         bool(args.trace), device, T_START)
    loaded = env.forbidden_loaded()
    if loaded:
        print(f"forbidden modules were loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    result["device"].update(kind=torch.cuda.get_device_name(0),
                            count=int(cell["chips"]))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
