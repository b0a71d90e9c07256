"""A Depth Anything V2 training cell: closed-loop training through
``Trainer.train_epoch`` over the GPU-resident feed, as ``train.py``
drives the geometry-aware network, with the network's own weights,
reference and FLOP count.

Set-up: seeded scenes made on the device at the configuration's size
(518x686: each sensor's K scaled per axis, as DA-V2's aspect-keeping
resize scales a 480x640 frame) and written as a pack under the run's
``TMPDIR``, the ``Trainer`` built over it by the port's own loaders with
the deployment's ``store_rows`` in its store, the seeded weights
(``core/weights_dav2.py``) loaded into its model, the three steps that
``correct`` reads (``check/train_dav2.py``), then ``warmup_steps`` steps
of an epoch cut short. The window calls ``train_epoch`` and closes at
the first batch boundary after ``--seconds``; ``train_images_per_s`` is
every image stepped over the whole time. A port without the network
(no ``depth_anything_v2`` among its architectures) exits at once with
status 2.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict

import torch

from benchmark.check import train_dav2 as check
from benchmark.core import env
from benchmark.core.program import loaders, program_config, write_pack
from benchmark.core.weights_dav2 import layout, seeded_state
from benchmark.drivers.spans import Spans, TimedCall, TimedIterable, stage
from benchmark.drivers.train import Cut
from benchmark.metrics.lib.dav2_flops import model_flops
from benchmark.metrics.lib.trace import Stretch
from benchmark.traffic.scenes import structured_scenes

ARCHITECTURE = "depth_anything_v2"


def _require_network(conf: Dict) -> None:
    from cadepth_tpu_torch.models import factory

    arch = conf["config"]["model"]["architecture"]
    if arch not in factory.ARCHITECTURES:
        print(f"this port has no {arch!r} network", file=sys.stderr)
        raise SystemExit(2)


def build(conf: Dict, seed: int, device: torch.device, scratch,
          t_start: float):
    """(trainer, its feed's ``Cut``, scenes on the device)."""
    from cadepth_tpu_torch.training.trainer import Trainer

    _require_network(conf)
    stage("import", t_start)
    cfg = program_config(conf, seed, scratch)
    bsz = cfg.training.batch_size
    if int(conf["store_rows"]) < check.STEPS * bsz:
        raise ValueError(f"{conf['store_rows']} rows hold fewer than the "
                         f"{check.STEPS} batches of {bsz} that correct reads")
    scenes = structured_scenes(int(conf["scenes"]), cfg.data.input_height,
                               cfg.data.input_width, seed, device)
    write_pack({k: v.cpu().numpy() for k, v in scenes.items()},
               scratch / "pack")
    stage("scenes", t_start)
    trainer = Trainer(cfg, *loaders(cfg, int(conf["store_rows"])),
                      device=device)
    stage("trainer", t_start)
    trainer.model.load_state_dict(seeded_state(layout(conf), seed, device))
    stage("weights", t_start)
    cut = Cut(trainer.train_pipe)
    trainer.train_pipe = cut
    return trainer, cut, scenes


def run(cell: Dict, conf: Dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> Dict:
    tr = cell["mix"]
    cuda = device.type == "cuda"
    scratch = env.scratch_dir("bench_train_dav2_")
    trainer, cut, scenes = build(conf, seed, device, scratch, t_start)
    cfg = trainer.cfg
    bsz = cfg.training.batch_size
    prog = check.program_steps(trainer, conf, seed, device)
    stage("first_steps", t_start)
    warm = int(tr["warmup_steps"])
    cut.before = lambda i: i < warm
    trainer.train_epoch(1)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    stage("warmup", t_start)

    spans = Spans()
    feed, step = cut, trainer.train_step
    if trace:
        trainer.train_pipe = TimedIterable(cut, spans, "feed")
        trainer.train_step = TimedCall(step, spans, "step")
    epoch, failed = 2, 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    cut.before = lambda i: time.perf_counter() < deadline
    handed = cut.handed
    while time.perf_counter() < deadline:
        before = cut.handed
        loss = trainer.train_epoch(epoch)
        epoch += 1
        failed += 0 if math.isfinite(loss) else cut.handed - before
    window = time.perf_counter() - t0
    steps = cut.handed - handed
    images_per_s = steps * bsz / window
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    found = None
    if trace and cuda:
        stretch = Stretch(torch, int(tr["profile_skip"]),
                          int(tr["profile_steps"]))
        cut.before = stretch.before
        trainer.train_pipe, trainer.train_step = feed, step
        trainer.train_epoch(epoch)
        found = stretch.finish()

    trainer.close()
    del trainer, cut, feed, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = check.reference_steps(conf, scenes, seed, device)
    numbers = check.compare(prog, ref)

    context = {"images_per_s": images_per_s, "spans": spans, "trace": found,
               "use_amp": cfg.training.use_amp}
    if trace:
        context["flops_per_image"] = model_flops(conf, bsz) / bsz
    return {"end_to_end": {"train_images_per_s": images_per_s,
                           "peak_mem_gib": peak / 2 ** 30,
                           "setup_s": setup_s},
            "numbers": numbers, "attempted": steps, "failed": failed,
            "peak_bytes": peak, "context": context, "scratch": scratch,
            "window_s": window}
