"""The port's spans (``cadepth_tpu_torch.utils.profiling``), on the CPU.

The flagship at init_features 8, 64x64, f32, batch 2, trained by a
``Trainer`` over a pack held on the device (the CPU here) and served by
a ``Predictor``. Held:

- Off: a ``TrainStep`` call and a ``predict_stream`` outside a profiler
  record nothing, and the step's autograd graph holds no mark.
- On, under ``torch.profiler.profile(activities=[CPU])``: an epoch's
  spans nest as the layers do (feed, step and its four phases, log
  reads, epoch end), each step's children carry its trace id
  (``updates`` on entry); one ``norm.fwd`` and one ``norm.bwd`` per
  call of ``apply_norm``; each served request's children share its id.
- Marks are exact: the parameters, gradients and running statistics
  after a step with tracing on equal those of a step with it off.
- Clock: each span's start and end lie within 200 us of its own range in
  the profile (``trace_start_ns()`` plus the range's relative times).
- Set-up spans are recorded without a profiler; the ring stays bounded.
"""

from __future__ import annotations

import copy
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch.data.packed import pack_dataset
from cadepth_tpu_torch.data.synthetic import generate_synthetic_dataset
from cadepth_tpu_torch.inference import Predictor
from cadepth_tpu_torch.models import layers
from cadepth_tpu_torch.training import train_state as ts
from cadepth_tpu_torch.training import trainer as p_trainer
from cadepth_tpu_torch.utils import profiling

H = W = 64
BATCH = 2
STEP_PHASES = ("train.forward", "train.loss", "train.backward",
               "train.update")

torch.set_num_threads(1)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    """A Trainer over 4 synthetic scenes packed at 64x64, held on the
    device (the CPU), with the set-up spans it recorded."""
    root = tmp_path_factory.mktemp("torch_tracing")
    manifest = generate_synthetic_dataset(str(root), images_per_sensor=1,
                                          seed=5)
    pack_dataset(f"{root}/sunrgbd", manifest, str(root / "pack"), H, W,
                 num_threads=2)
    cfg = port_config.config_from_dict({
        "experiment": {"name": "tracing", "seed": 3},
        "data": {"packed_dir": str(root / "pack"), "device_resident": True,
                 "input_height": H, "input_width": W, "compute_rays": True},
        "model": {"architecture": "geometry_aware", "init_features": 8},
        "optimization": {"optimizer": "adamw", "learning_rate": 1e-3,
                         "lr_scheduler": "none", "lr_warmup_epochs": 0},
        "training": {"num_epochs": 1, "batch_size": BATCH,
                     "log_interval": 1, "use_amp": False},
        "checkpointing": {"checkpoint_dir": str(root / "ckpts")},
        "logging": {"log_dir": str(root / "logs"),
                    "tensorboard": {"enabled": False}},
        "early_stopping": {"enabled": False},
    })
    profiling.clear_spans()
    tr = p_trainer.Trainer(cfg, device="cpu")
    setup = profiling.recorded_spans()
    yield tr, setup
    tr.close()


@pytest.fixture(scope="module")
def batch(trainer):
    tr, _ = trainer
    return next(iter(tr.train_pipe))


def _norm_calls(model):
    """A counter of the calls into the modules that ``apply_norm`` runs
    (the blocks' batch norms), and the hooks to remove."""
    calls = Counter()
    hooks = [m.register_forward_pre_hook(
        lambda *_: calls.update(["norm"]))
        for m in model.modules() if type(m) is layers.BatchNorm2d]
    return calls, hooks


def _graph_names(root):
    seen, names, todo = set(), [], [root.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_setup_spans_are_recorded_without_a_profiler(trainer):
    tr, setup = trainer
    by = {s["name"]: s for s in setup}
    assert set(by) == {"setup.store", "setup.model"}
    store = by["setup.store"]
    assert store["session"] is None and store["parent"] is None
    assert store["attrs"]["bytes"] == tr.train_pipe.dataset.nbytes() > 0
    assert by["setup.model"]["end_ns"] > by["setup.model"]["start_ns"] >= \
        store["end_ns"]


def test_off_records_nothing_and_marks_nothing(trainer, batch):
    tr, _ = trainer
    profiling.clear_spans()
    assert profiling.span("train.step") is profiling.OFF
    model = tr.model
    model.train()
    pred = model(*ts._inputs(tr.cfg, batch))
    assert "_MarkBackward" not in _graph_names(pred)
    tr.train_step(batch)
    pred = Predictor(tr.cfg, state_dict=tr.model.state_dict(),
                     batch_size=BATCH, device="cpu")
    rgb = batch["rgb"].numpy()
    list(pred.predict_stream([rgb, rgb[:1]]))
    assert profiling.recorded_spans() == []


def test_an_epoch_nests_its_spans_by_layer(trainer):
    tr, _ = trainer
    profiling.clear_spans()
    steps = len(tr.train_pipe)
    first = tr.train_step.updates
    calls, hooks = _norm_calls(tr.model)
    with _cpu_profile():
        tr.train_epoch(0)
    for h in hooks:
        h.remove()
    spans = profiling.recorded_spans()
    by_id = {s["id"]: s for s in spans}
    names = Counter(s["name"] for s in spans)
    assert names["train.step"] == steps
    assert names["train.feed"] == steps + 1       # the last one ends it
    assert names["train.log_read"] == steps       # log_interval 1
    assert names["train.epoch_end"] == 1
    for phase in STEP_PHASES:
        assert names[phase] == steps
    assert names["norm.fwd"] == names["norm.bwd"] == calls["norm"] > 0
    assert len({s["session"] for s in spans}) == 1
    step_ids = {s["trace"]: s["id"] for s in spans
                if s["name"] == "train.step"}
    assert sorted(step_ids) == list(range(first, first + steps))
    for s in spans:
        parent = by_id.get(s["parent"])
        if s["name"] in STEP_PHASES:
            assert parent["name"] == "train.step"
        elif s["name"] == "norm.fwd":
            assert parent["name"] == "train.forward"
        elif s["name"] == "norm.bwd":
            # the backward runs on the calling thread on the CPU
            assert parent["name"] == "train.backward"
        else:
            assert s["parent"] is None
        if s["name"] != "train.epoch_end":
            assert s["trace"] in step_ids or (
                s["name"] == "train.feed" and s["trace"] == first + steps)
        if parent is not None:
            assert s["trace"] == parent["trace"]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
                parent["end_ns"] or s["name"] == "norm.bwd"
        assert s["device_ms"] is None                 # no card
    per_step = Counter(s["trace"] for s in spans if s["name"] == "norm.fwd")
    assert set(per_step.values()) == {names["norm.fwd"] // steps}


def test_served_requests_carry_their_ids(trainer, batch):
    tr, _ = trainer
    pred = Predictor(tr.cfg, state_dict=tr.model.state_dict(),
                     batch_size=BATCH, device="cpu")
    rgb, k = batch["rgb"].numpy(), batch["intrinsics"].numpy()
    profiling.clear_spans()
    with _cpu_profile():
        out = list(pred.predict_stream([(rgb, k), (rgb[:1], k[:1]),
                                        (rgb, k)], depth=2))
        pred.predict(rgb, k)
    spans = profiling.recorded_spans()
    requests = {s["id"]: s for s in spans if s["name"] == "serve.request"}
    assert sorted(r["trace"] for r in requests.values()) == [1, 2, 3, 4]
    children = defaultdict(list)
    for s in spans:
        if s["name"].startswith("serve.") and s["name"] != "serve.request":
            req = requests[s["parent"]]
            assert s["trace"] == req["trace"]
            assert req["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
                req["end_ns"]
            children[req["trace"]].append(s["name"])
    for trace in (1, 2, 3, 4):
        assert children[trace] == ["serve.pad", "serve.h2d", "serve.forward",
                                   "serve.readback"]
    # a request of one image reads back one depth map
    backs = sorted((s["trace"], s["attrs"]["bytes"]) for s in spans
                   if s["name"] == "serve.readback")
    assert [b for _, b in backs] == [o.nbytes for o in out] + [
        out[0].nbytes]
    h2d = [s["attrs"]["bytes"] for s in spans if s["name"] == "serve.h2d"]
    assert set(h2d) == {BATCH * H * W * 3 * 4 + BATCH * (9 + 4) * 4}


def test_marks_leave_the_step_exact(trainer, batch):
    tr, _ = trainer
    results = []
    for traced in (False, True):
        model = copy.deepcopy(tr.model)
        opt = ts.build_optimizer(tr.cfg.optimization,
                                        model.parameters())
        step = ts.make_train_step(tr.cfg, model, tr.loss_fn, opt,
                                         tr.lr_schedule)
        if traced:
            with _cpu_profile():
                step(batch)
        else:
            step(batch)
        results.append((
            {n: p.detach().clone() for n, p in model.named_parameters()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()}))
    for off, on in zip(*results):
        assert off.keys() == on.keys()
        for name in off:
            assert torch.equal(off[name], on[name]), name


def test_spans_sit_on_the_profilers_clock(trainer, batch):
    tr, _ = trainer
    tr.train_step(batch)                  # every range entered once before
    profiling.clear_spans()
    with _cpu_profile() as prof:
        tr.train_step(batch)
    spans = profiling.recorded_spans()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            ranges[e.name].append((t0 + round(e.time_range.start * 1e3),
                                   t0 + round(e.time_range.end * 1e3)))
    mine = defaultdict(list)
    for s in spans:
        mine[s["name"]].append((s["start_ns"], s["end_ns"]))
    assert set(mine) >= {"train.step", "norm.fwd", "norm.bwd"}
    for name, got in mine.items():
        want = sorted(ranges[name])
        assert len(want) == len(got), name
        gap = np.abs(np.asarray(sorted(got)) - np.asarray(want))
        assert gap.max() < 200_000, (name, gap.max())


def test_the_ring_stays_bounded():
    profiling.clear_spans()
    for i in range(profiling.RING + 5):
        profiling.span("setup.store", always=True, i=i).close()
    spans = profiling.recorded_spans()
    assert len(spans) == profiling.RING
    assert spans[0]["attrs"]["i"] == 5
    profiling.clear_spans()
    assert profiling.recorded_spans() == []
