"""Readings of a cell's compared numbers on the card at the cell's own
size, for its limits: the port itself (``none``, the lower readings),
the control and the planted faults (the upper ones).

    python benchmark/control.py --workload <cell> --seeds 11,12,13 \\
        --faults none,float8,half_batch

Each reading is the cell's own comparison against the float32
reference, of: ``none`` the port, set up as a run sets it up (its first
three steps, or its answers to the first requests); ``float8`` the
control, the reference in the port's place on float8 e4m3 operands in
every convolution and gated dense layer, the step below the
configuration's bfloat16; ``half_batch`` (training) the reference
taking each step's mean over the first half of its batch; ``altered``
(serving) the reference's answers handed to the wrong frames, rotated by
one. One process reads every seed (set-up is long); one JSON line a seed
and reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark.core import env, manifest  # noqa: E402

env.prepare()

FAULTS = ("none", "float8", "half_batch", "altered")


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _train(conf, seed, faults, device):
    from benchmark.check import train as check
    from benchmark.drivers import train as driver
    from benchmark.traffic.scenes import structured_scenes

    c = conf["config"]
    out = {}
    if "none" in faults:
        scratch = env.scratch_dir("bench_control_")
        trainer, _, scenes = driver.build(conf, seed, device, scratch,
                                          time.perf_counter())
        prog = check.program_steps(trainer, conf, seed, device)
        trainer.close()
        del trainer, _
        shutil.rmtree(scratch, ignore_errors=True)
        _free(device)
    else:
        scenes = structured_scenes(int(conf["scenes"]),
                                   c["data"]["input_height"],
                                   c["data"]["input_width"], seed, device)
    ref = check.reference_steps(conf, scenes, seed, device)
    for fault in faults:
        if fault == "none":
            bad = prog
        else:
            bad = check.reference_steps(
                conf, scenes, seed, device,
                precision="float8" if fault == "float8" else "float32",
                half_batch=fault == "half_batch")
        out[fault] = check.compare(bad, ref)
        _free(device)
    return out


def _serve(cell, conf, seed, faults, device):
    import numpy as np

    from benchmark.check import serve as check
    from benchmark.drivers import serve as driver

    scratch = env.scratch_dir("bench_control_")
    pred, requests = driver.build(cell, conf, seed, device, scratch,
                                  time.perf_counter())
    items = [requests.make(i)
             for i in range(int(cell["mix"]["check_requests"]))]
    served = [pred.predict(r["rgb"], r["k"]) for r in items] \
        if "none" in faults else None
    del pred
    shutil.rmtree(scratch, ignore_errors=True)
    _free(device)
    ref = check.reference_depths(conf, items, seed, device)
    out = {}
    for fault in faults:
        if fault == "none":
            bad = served
        elif fault == "altered":
            bad = [np.roll(r, 1, axis=0) for r in ref]
        else:
            bad = check.reference_depths(conf, items, seed, device,
                                         "float8")
        out[fault] = check.compare(bad, ref)
    return out


def readings(cell: dict, conf: dict, seed: int, faults, device) -> dict:
    """{fault: the cell's numbers} for one seed."""
    if cell["mix"]["driver"] == "train":
        return _train(conf, seed, list(faults), device)
    return _serve(cell, conf, seed, list(faults), device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="float8")
    args = p.parse_args(argv)
    import torch

    faults = args.faults.split(",")
    if not set(faults) <= set(FAULTS):
        p.error(f"faults are {', '.join(FAULTS)}")
    if not torch.cuda.is_available():
        print("the readings are the card's", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    conf = manifest.config(cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault, numbers in readings(cell, conf, seed, faults,
                                       torch.device("cuda", 0)).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": fault, "numbers": numbers}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
