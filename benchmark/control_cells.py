"""``control.py``'s readings for the cells whose drivers it does not
know: Depth Anything V2's training (``train_dav2``) and data-parallel
training (``train_dp``), on the card at the cell's own size, for their
limits.

    python benchmark/control_cells.py --workload dav2_vitl_train_b8 \\
        --seeds 11,12,13 --faults none,float8,half_batch
    python benchmark/control_cells.py --workload production_train_dp4 \\
        --seeds 11 --faults none,float8,half_batch,drop_rank

Each reading is the cell's own comparison against its float32
reference, of: ``none`` the port, set up as a run sets it up (its first
three steps); ``float8`` the control, the reference in the port's place
on float8 e4m3 operands where the port computes in bfloat16;
``half_batch`` the reference's loss over the first half of each batch
(of each rank's rows); ``drop_rank`` (data parallel) the port with the
last rank's gradient left out of its all-reduce, in its three steps. A
data-parallel cell's readings start its ranks as a run does, one process
a card. One JSON line a seed and reading; the benchmark's own runs never
run this.
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

FAULTS = ("none", "float8", "half_batch", "drop_rank")


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def dav2_readings(conf, seed, faults, device) -> dict:
    from benchmark.check import train_dav2 as check
    from benchmark.drivers import train_dav2 as driver
    from benchmark.traffic.scenes import structured_scenes

    c = conf["config"]
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
    out = {}
    for fault in faults:
        bad = prog if fault == "none" else check.reference_steps(
            conf, scenes, seed, device,
            precision="float8" if fault == "float8" else "float32",
            half_batch=fault == "half_batch")
        out[fault] = check.compare(bad, ref)
        _free(device)
    return out


def dp_readings(spec, rank, device) -> dict:
    """Every rank's part of one seed's readings; rank 0's are returned."""
    from benchmark.check import train_dp as check_dp
    from benchmark.drivers import train_dp as driver
    from benchmark.traffic.scenes import structured_scenes
    from cadepth_tpu_torch.parallel.mesh import make_mesh

    conf, seed, faults = spec["conf"], spec["seed"], spec["faults"]
    driver._join(spec, rank, device)
    dp = make_mesh()
    c = conf["config"]
    scenes = structured_scenes(int(conf["scenes"]), c["data"]["input_height"],
                               c["data"]["input_width"], seed, device)
    ports = {}
    for fault in ("none", "drop_rank"):
        if fault in faults:
            trainer, _, _ = driver.build(conf, spec, rank, device,
                                         time.perf_counter())
            ports[fault] = check_dp.program_steps(
                trainer, conf, seed, device, drop_rank=fault == "drop_rank")
            trainer.close()
            del trainer, _
            _free(device)
    ref = check_dp.reference_steps(conf, scenes, seed, device)
    out = {}
    for fault in faults:
        bad = ports[fault] if fault in ports else check_dp.reference_steps(
            conf, scenes, seed, device,
            precision="float8" if fault == "float8" else "float32",
            half_batch=fault == "half_batch")
        out[fault] = driver.compare(dp, bad, ref, device)
        _free(device)
    return out


def readings(cell, conf, seed, faults, device) -> dict:
    """{fault: the cell's numbers} for one seed."""
    driver = cell["mix"]["driver"]
    if driver == "train_dav2":
        return dav2_readings(conf, seed, faults, device)
    if driver != "train_dp":
        raise ValueError(f"control.py reads cells of driver {driver!r}")
    from benchmark.drivers import train_dp

    spec, procs, scratch = train_dp.start(cell, conf, seed, device,
                                          "control", faults=list(faults))
    out = dp_readings(spec, 0, device)
    train_dp.finish(procs)
    shutil.rmtree(scratch, ignore_errors=True)
    return out


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
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault, numbers in readings(cell, conf, seed, faults,
                                       device).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": fault, "numbers": numbers}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
