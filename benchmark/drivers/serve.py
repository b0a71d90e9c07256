"""A serving cell: one closed-loop client streaming requests through
``Predictor.predict_stream``.

A request is ``batch`` host frames (numpy float32, the predictor's input
size) and their K. The frames come from a pool of ``pool_scenes`` seeded
scenes, cut into fixed request batches by a seeded permutation and
cycled; each frame's K is its scene's sensor's (SUN RGB-D's four,
``traffic/cameras.py``), as in a recorded multi-sensor archive. A
request's latency runs from its
hand-over to the predictor to its depth map on the host;
``serve_images_per_s`` is every image answered over the window, which
ends with the last answer to a request handed over before ``--seconds``.
"""

from __future__ import annotations

import gc
import itertools
import time
from typing import Dict

import numpy as np
import torch

from benchmark.check import serve as check
from benchmark.core import env
from benchmark.core.program import program_config
from benchmark.core.weights import layout, seeded_state
from benchmark.drivers.spans import Spans, TimedCall, stage
from benchmark.metrics.lib import roofline
from benchmark.metrics.lib.trace import Stretch
from benchmark.traffic.scenes import structured_scenes

REQUESTS_STREAM = 0x5251


class Requests:
    """The seeded request stream: ``make(i)`` is request i."""

    def __init__(self, tr: Dict, h: int, w: int, seed: int, device):
        bsz, n = int(tr["batch"]), int(tr["pool_scenes"])
        if n % bsz:
            raise ValueError("pool_scenes must be a multiple of batch")
        scenes = structured_scenes(n, h, w, seed, device)
        rgb = scenes["rgb"].cpu().numpy()
        k = scenes["k"].cpu().numpy()
        order = np.random.default_rng([seed, REQUESTS_STREAM]).permutation(n)
        self.pool = [np.ascontiguousarray(rgb[order[i:i + bsz]])
                     for i in range(0, n, bsz)]
        self.k = [k[order[i:i + bsz]] for i in range(0, n, bsz)]

    def make(self, i: int) -> Dict[str, np.ndarray]:
        j = i % len(self.pool)
        return {"rgb": self.pool[j], "k": self.k[j]}


def _warps(model):
    """The PCLs of the port's model: modules carrying a ``warp``
    function."""
    return [m for m in model.modules()
            if callable(getattr(m, "warp", None))
            and not isinstance(getattr(m, "warp"), torch.nn.Module)]


def build(cell: Dict, conf: Dict, seed: int, device: torch.device,
          scratch, t_start: float):
    """(predictor, requests): the port's ``Predictor`` holding the
    seeded weights, and the seeded request stream."""
    from cadepth_tpu_torch.inference import Predictor

    stage("import", t_start)
    cfg = program_config(conf, seed, scratch)
    requests = Requests(cell["mix"], cfg.data.input_height,
                        cfg.data.input_width, seed, device)
    stage("requests", t_start)
    state = seeded_state(layout(cfg.model.init_features), seed, device)
    stage("weights", t_start)
    pred = Predictor(cfg, state_dict=state, batch_size=int(
        cell["mix"]["batch"]), device=device)
    stage("predictor", t_start)
    return pred, requests


def run(cell: Dict, conf: Dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> Dict:
    tr = cell["mix"]
    cuda = device.type == "cuda"
    scratch = env.scratch_dir("bench_serve_")
    pred, requests = build(cell, conf, seed, device, scratch, t_start)
    cfg = pred.cfg
    h, w = cfg.data.input_height, cfg.data.input_width
    bsz = int(tr["batch"])
    counter = itertools.count()
    warm = [requests.make(next(counter)) for _ in range(int(tr["warmup"]))]
    for _ in pred.predict_stream(((r["rgb"], r["k"]) for r in warm),
                                 depth=int(tr["depth"])):
        pass
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    stage("warmup", t_start)

    spans = Spans()
    if trace:
        pred._make_batch = TimedCall(pred._make_batch, spans, "stage")
    sample = check.Reservoir(int(tr["check_requests"]), seed)
    handed, latency, failed = [], [], 0
    t0 = time.perf_counter()

    def stream():
        while time.perf_counter() - t0 < seconds:
            req = requests.make(next(counter))
            handed.append((req, time.perf_counter()))
            yield req["rgb"], req["k"]

    for i, out in enumerate(pred.predict_stream(stream(),
                                                depth=int(tr["depth"]))):
        latency.append(time.perf_counter() - handed[i][1])
        if out.shape != (bsz, h, w, 1):
            failed += 1
        sample.offer(lambda: {**handed[i][0], "depth": out.copy()})
    window = time.perf_counter() - t0
    done = len(latency)
    failed += len(handed) - done
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    found = None
    if trace and cuda:
        def profile(host_ops):
            stretch = Stretch(torch, int(tr["profile_skip"]),
                              int(tr["profile_requests"]), host_ops)

            def stream():
                i = 0
                while stretch.before(i):
                    r = requests.make(next(counter))
                    yield r["rgb"], r["k"]
                    i += 1

            for _ in pred.predict_stream(stream(), depth=int(tr["depth"])):
                pass
            return stretch.finish()

        found = profile(False)
        for m in _warps(pred.model):
            m.warp = TimedCall(m.warp, Spans(), "warp")
        # every request of the second profile runs its warps inside it
        found.ranges = profile(True).ranges
        found.forwards = int(tr["profile_requests"]) + 2

    del pred
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    items = sample.items
    ref = check.reference_depths(conf, items, seed, device)
    numbers = check.compare([x["depth"] for x in items], ref)

    lat = np.asarray(latency) * 1e3
    context = {"images_per_s": done * bsz / window, "spans": spans,
               "trace": found, "use_amp": cfg.training.use_amp,
               "warp_bound_s": sum(roofline.bound_s(v) for v in
                                   roofline.warp_bytes(
                                       bsz, h, w, cfg.model.init_features,
                                       elem_bytes=2 if cfg.training.use_amp
                                       else 4).values())}
    if trace:
        context["flops_per_image"] = roofline.model_flops(
            cfg.model.init_features, bsz, h, w, train=False) / bsz
    return {"end_to_end": {"serve_images_per_s": done * bsz / window,
                           "serve_p95_ms": float(np.percentile(lat, 95)),
                           "peak_mem_gib": peak / 2 ** 30,
                           "setup_s": setup_s},
            "numbers": numbers, "attempted": len(handed), "failed": failed,
            "peak_bytes": peak, "context": context, "scratch": scratch,
            "window_s": window}
