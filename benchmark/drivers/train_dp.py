"""A data-parallel training cell: the port's ``Trainer`` on ``ranks``
processes, one a card, joined by NCCL (Gloo on the CPU), with
``hardware.data_parallel``.

``run.py``'s process is rank 0 on card 0. It writes the seeded scenes'
pack once, builds the port's CUDA kernels once, then starts ranks 1 ..
W-1 as ``python -m benchmark.drivers.train_dp <spec> <rank>``, each on
card r, and drives its own rank; a rank that exits early ends the run
(no rank waits on a collective that will never come). The
configuration's ``training.batch_size`` is a card's share: the global
batch is W times it, and the split holds W x ``store_rows`` rows, so
each card's shard of the resident store holds ``store_rows``.

Every rank runs the same loop as ``train.py``: the three checked steps
(``check/train_dp.py``), warm-up, the window, and with ``--trace 1``
the stretch (profiled on rank 0 only). Each place a rank decides to stop
(a batch boundary, the window's end) is agreed over the ranks (any rank
past the deadline stops them all), so every rank takes the same steps.
``train_images_per_s`` is the W ranks' images over rank 0's window;
``peak_mem_gib`` the largest rank's peak. After the window every rank
works out its shard of the float32 reference, and the numbers are
compared on the global batch (the first depths of all W shards).
"""

from __future__ import annotations

import copy
import gc
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from benchmark.check import train as check
from benchmark.check import train_dp as check_dp
from benchmark.core import env
from benchmark.core.manifest import ROOT
from benchmark.core.program import loaders, program_config, write_pack
from benchmark.core.weights import layout, seeded_state
from benchmark.drivers.spans import Spans, TimedCall, TimedIterable, stage
from benchmark.drivers.train import Cut
from benchmark.metrics.lib import roofline
from benchmark.metrics.lib.trace import Stretch
from benchmark.traffic.scenes import structured_scenes

# seconds rank 0 waits for the others to exit once all have left the
# process group
JOIN_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _device(rank: int, cuda: bool) -> torch.device:
    return torch.device("cuda", rank) if cuda else torch.device("cpu")


def _start_ranks(spec: Path, ranks: int) -> List[subprocess.Popen]:
    """Ranks 1 .. ranks-1, their output on this process's standard error
    (descriptor 2: standard output carries rank 0's result alone), and a
    watchdog that ends this process if one of them fails."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.drivers.train_dp", str(spec),
         str(r)], cwd=str(ROOT), stdout=2, stderr=2)
        for r in range(1, ranks)]

    def watch():
        while True:
            for r, p in enumerate(procs, 1):
                code = p.poll()
                if code not in (None, 0):
                    print(f"rank {r} exited with status {code}",
                          file=sys.stderr, flush=True)
                    for q in procs:
                        if q.poll() is None:
                            q.kill()
                    os._exit(1)
            if all(p.poll() == 0 for p in procs):
                return
            time.sleep(0.5)

    threading.Thread(target=watch, daemon=True).start()
    return procs


def _watch_parent() -> None:
    """End this rank when rank 0's process has gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _join(spec: Dict, rank: int, device: torch.device) -> None:
    from cadepth_tpu_torch.parallel.distributed import initialize_distributed

    if device.type != "cuda":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // spec["ranks"]))
    initialize_distributed(f"localhost:{spec['port']}", spec["ranks"], rank,
                           backend="nccl" if device.type == "cuda"
                           else "gloo")


def global_conf(conf: Dict, ranks: int) -> Dict:
    """The configuration file as the W ranks run it: the global batch W
    times a card's."""
    out = copy.deepcopy(conf)
    out["config"]["training"]["batch_size"] *= ranks
    return out


def _any(dp, flag: bool) -> bool:
    return flag if dp is None else dp.any(flag)


def _gather_host(dp, x: np.ndarray) -> np.ndarray:
    """Every rank's ``x`` (same shape), rank order, on the host."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    parts = [torch.empty_like(t) for _ in range(dp.world_size)]
    dist.all_gather(parts, t, group=dp.host_group)
    return torch.cat(parts).numpy()


def _max_host(dp, x: float) -> float:
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=dp.host_group)
    return float(t)


def build(conf: Dict, spec: Dict, rank: int, device, t_start: float):
    """(trainer, its feed's ``Cut``, scenes on the device) on this rank."""
    from cadepth_tpu_torch.training.trainer import Trainer

    ranks = spec["ranks"]
    seed = spec["seed"]
    scratch = Path(spec["scratch"])
    cfg = program_config(global_conf(conf, ranks), seed, scratch)
    scenes = structured_scenes(int(conf["scenes"]), cfg.data.input_height,
                               cfg.data.input_width, seed, device)
    stage(f"rank {rank} scenes", t_start)
    trainer = Trainer(cfg, *loaders(cfg, ranks * int(conf["store_rows"])),
                      device=device)
    stage(f"rank {rank} trainer", t_start)
    trainer.model.load_state_dict(seeded_state(
        layout(cfg.model.init_features), seed, device))
    cut = Cut(trainer.train_pipe)
    trainer.train_pipe = cut
    return trainer, cut, scenes


def _gap(pairs) -> float:
    """The norm of the differences over the norm of the second of each
    pair (float64 tensors)."""
    off = whole = 0.0
    for got, want in pairs:
        off += float(torch.sum((got - want) ** 2))
        whole += float(torch.sum(want ** 2))
    gap = math.sqrt(off / whole) if whole > 0 else math.inf
    return gap if math.isfinite(gap) else math.inf


def _summed(prog, device):
    """(``grad_vec``, the ranks' ``grad_mine`` summed) a leaf at a time,
    on ``device``, in float64."""
    for k, g in prog.grad_vec.items():
        mine = prog.grad_mine.get(k, torch.zeros_like(g)).to(device,
                                                            torch.float64)
        dist.all_reduce(mine)
        yield g.to(device, torch.float64), mine


def compare(dp, prog, ref, device) -> Dict[str, float]:
    """``check/train.py``'s numbers over the global batch (the first
    depths of every rank's rows) and ``exchange_gap_first``
    (``check/train_dp.py``)."""
    whole = []
    for readings in (prog, ref):
        whole.append(copy.copy(readings))
        whole[-1].pred0 = _gather_host(dp, readings.pred0)
    return {**check.compare(*whole),
            "exchange_gap_first": _gap(_summed(prog, device))}


def rank_run(spec: Dict, rank: int, device, t_start: float) -> Dict:
    """One rank's part of a run; rank 0's result is the cell's."""
    cell, conf, seed = spec["cell"], spec["conf"], spec["seed"]
    tr = cell["mix"]
    cuda = device.type == "cuda"
    _join(spec, rank, device)
    stage(f"rank {rank} joined", t_start)
    trainer, cut, scenes = build(conf, spec, rank, device, t_start)
    dp = trainer.dp
    cfg = trainer.cfg
    bsz = cfg.training.batch_size
    prog = check_dp.program_steps(trainer, conf, seed, device)
    warm = int(tr["warmup_steps"])
    cut.before = lambda i: i < warm
    trainer.train_epoch(1)
    if cuda:
        torch.cuda.synchronize(device)
    dp.barrier()
    setup_s = time.perf_counter() - t_start
    stage(f"rank {rank} warmup", t_start)

    spans = Spans()
    feed, step = cut, trainer.train_step
    if spec["trace"] and rank == 0:
        trainer.train_pipe = TimedIterable(cut, spans, "feed")
        trainer.train_step = TimedCall(step, spans, "step")
    epoch, failed = 2, 0
    t0 = time.perf_counter()
    deadline = t0 + spec["seconds"]
    cut.before = lambda i: not _any(dp, time.perf_counter() >= deadline)
    handed = cut.handed
    while not _any(dp, time.perf_counter() >= deadline):
        before = cut.handed
        loss = trainer.train_epoch(epoch)
        epoch += 1
        failed += 0 if math.isfinite(loss) else cut.handed - before
    window = time.perf_counter() - t0
    steps = cut.handed - handed
    images_per_s = steps * bsz / window
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    found = None
    if spec["trace"]:
        skip, n = int(tr["profile_skip"]), int(tr["profile_steps"])
        stretch = Stretch(torch, skip, n) if cuda and rank == 0 else None
        cut.before = stretch.before if stretch else \
            (lambda i: i < skip + n + 2)
        trainer.train_pipe, trainer.train_step = feed, step
        trainer.train_epoch(epoch)
        if stretch:
            found = stretch.finish()

    trainer.close()
    del trainer, cut, feed, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = check_dp.reference_steps(conf, scenes, seed, device)
    numbers = compare(dp, prog, ref, device)
    peak = _max_host(dp, float(peak))

    # mfu.train reads a card's share of the rate: the W cards' FLOPs a
    # second over W cards' peak
    context = {"images_per_s": images_per_s / dp.world_size, "spans": spans,
               "trace": found, "use_amp": cfg.training.use_amp}
    if spec["trace"]:
        context["flops_per_image"] = roofline.model_flops(
            cfg.model.init_features, bsz // dp.world_size,
            cfg.data.input_height, cfg.data.input_width,
            train=True) / (bsz // dp.world_size)
    return {"end_to_end": {"train_images_per_s": images_per_s,
                           "peak_mem_gib": peak / 2 ** 30,
                           "setup_s": setup_s},
            "numbers": numbers, "attempted": steps, "failed": failed,
            "peak_bytes": int(peak), "context": context,
            "window_s": window}


def start(cell: Dict, conf: Dict, seed: int, device, mode: str,
          **extra) -> tuple:
    """(spec, the other ranks' processes, scratch) of a run over
    ``cell['mix']['ranks']`` ranks, this process rank 0: the scenes' pack
    written and the kernels built before the others start."""
    ranks = int(cell["mix"]["ranks"])
    cuda = device.type == "cuda"
    if cuda and torch.cuda.device_count() < ranks:
        raise RuntimeError(f"{ranks} ranks need {ranks} cards; "
                           f"{torch.cuda.device_count()} are visible")
    scratch = env.scratch_dir("bench_train_dp_")
    c = conf["config"]
    scenes = structured_scenes(int(conf["scenes"]), c["data"]["input_height"],
                               c["data"]["input_width"], seed, device)
    write_pack({k: v.cpu().numpy() for k, v in scenes.items()},
               scratch / "pack")
    del scenes
    if cuda:
        from cadepth_tpu_torch.ops import _build
        _build.build_all()
    spec = {"cell": cell, "conf": conf, "seed": int(seed), "ranks": ranks,
            "port": _free_port(), "scratch": str(scratch), "mode": mode,
            "cuda": cuda, **extra}
    path = scratch / "spec.json"
    path.write_text(json.dumps(spec))
    return spec, _start_ranks(path, ranks), scratch


def finish(procs: List[subprocess.Popen]) -> None:
    """Leave the process group with the other ranks (under NCCL every
    rank must, at once: a rank that waits for the others to exit first
    waits for ever), then wait for them to exit."""
    dist.destroy_process_group()
    for p in procs:
        p.wait(timeout=JOIN_S)


def run(cell: Dict, conf: Dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> Dict:
    spec, procs, scratch = start(cell, conf, seed, device, "run",
                                 seconds=float(seconds), trace=bool(trace))
    stage("ranks started", t_start)
    out = rank_run(spec, 0, device, t_start)
    finish(procs)
    out["scratch"] = scratch
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    spec = json.loads(Path(argv[0]).read_text())
    rank = int(argv[1])
    _watch_parent()
    device = _device(rank, spec["cuda"])
    if spec["cuda"]:
        torch.cuda.set_device(device)
    if spec["mode"] == "run":
        rank_run(spec, rank, device, time.perf_counter())
    else:
        from benchmark.control_cells import dp_readings
        dp_readings(spec, rank, device)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    env.prepare()
    sys.exit(main())
