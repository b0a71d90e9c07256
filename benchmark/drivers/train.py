"""A training cell: closed-loop training through ``Trainer.train_epoch``
over the GPU-resident feed.

Set-up: seeded scenes made on the device and written as a pack under
the run's ``TMPDIR``, the ``Trainer`` built over it by the port's own
loaders with the deployment's ``store_rows`` in its store, the seeded
weights loaded into its model, the three steps that ``correct`` reads
(``check/train.py``), then ``warmup_steps`` steps of an epoch cut short
(its log reads and its end included). The window calls ``train_epoch``
and closes at the first batch boundary after ``--seconds``: the feed
stops handing over batches, the epoch's loop ends and its read of the
mean loss waits for the card. An epoch of the deployment's store is
longer than the window, so the window times the steady state, with the
log reads every ``log_interval`` steps as a user's run has them;
``train_images_per_s`` is every image stepped over the whole time.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict

import torch

from benchmark.check import train as check
from benchmark.core import env
from benchmark.core.program import loaders, program_config, write_pack
from benchmark.core.weights import layout, seeded_state
from benchmark.drivers.spans import Spans, TimedCall, stage, TimedIterable
from benchmark.metrics.lib import roofline
from benchmark.metrics.lib.trace import Stretch
from benchmark.traffic.scenes import structured_scenes


class Cut:
    """The trainer's feed, asking ``before(i)`` ahead of drawing batch i
    of an epoch and ending the epoch where it is False; ``handed``
    counts the batches it has handed over; its length reads through."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.before: Callable[[int], bool] = lambda i: True
        self.handed = 0

    def __len__(self):
        return len(self.pipe)

    def __iter__(self):
        it = iter(self.pipe)
        i = 0
        while self.before(i):
            try:
                batch = next(it)
            except StopIteration:
                return
            self.handed += 1
            yield batch
            i += 1


def build(conf: Dict, seed: int, device: torch.device, scratch,
          t_start: float):
    """(trainer, its feed's ``Cut``, scenes on the device): the port's
    ``Trainer`` over the seeded scenes, its model holding the seeded
    weights."""
    from cadepth_tpu_torch.training.trainer import Trainer

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
    trainer.model.load_state_dict(seeded_state(
        layout(cfg.model.init_features), seed, device))
    stage("weights", t_start)
    cut = Cut(trainer.train_pipe)
    trainer.train_pipe = cut
    return trainer, cut, scenes


def run(cell: Dict, conf: Dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> Dict:
    tr = cell["mix"]
    cuda = device.type == "cuda"
    scratch = env.scratch_dir("bench_train_")
    trainer, cut, scenes = build(conf, seed, device, scratch, t_start)
    cfg = trainer.cfg
    h, w = cfg.data.input_height, cfg.data.input_width
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
        context["flops_per_image"] = roofline.model_flops(
            cfg.model.init_features, bsz, h, w, train=True) / bsz
    return {"end_to_end": {"train_images_per_s": images_per_s,
                           "peak_mem_gib": peak / 2 ** 30,
                           "setup_s": setup_s},
            "numbers": numbers, "attempted": steps, "failed": failed,
            "peak_bytes": peak, "context": context, "scratch": scratch,
            "window_s": window}
