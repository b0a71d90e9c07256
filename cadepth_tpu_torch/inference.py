"""Fixed-shape depth predictor (port of ``cadepth_tpu.inference``).

One model at one batch size and input size: requests with fewer than
``batch_size`` images are zero-padded to the batch and the padding rows
are dropped from the answer, so every forward runs at the same shapes.

    predictor = Predictor.from_checkpoint(cfg, "best", batch_size=8)
    depth = predictor.predict(rgb_batch, intrinsics)      # numpy in/out
    stats = predictor.benchmark()                          # p50/p95/p99
    predictor.export("depth.pt2")                          # torch.export
    fn = load_exported("depth.pt2"); depth = fn(batch)     # no model code

Weights come from a checkpoint the port's trainer wrote
(:meth:`Predictor.from_checkpoint`), from
:mod:`cadepth_tpu_torch.convert` (a JAX checkpoint's variables) or,
without a ``state_dict``, from the port's seeded initialisation.

An exported program is locked to the predictor's batch size, input size
and device, as the JAX package's StableHLO artifact is; it is read back
by the torch version that wrote it.

While a profiler records (``utils/profiling.py``), each request of
``predict`` and ``predict_stream`` is span ``serve.request``, from its
hand-over to its depth on the host, its trace id the request's number in
this predictor; its children are ``serve.pad`` (the host batch: padding,
K, k4, rays), ``serve.h2d`` (the copies to the card, attribute
``bytes``), ``serve.forward`` (with the card's time) and
``serve.readback`` (the depth's copy to the host, attribute ``bytes``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch

from cadepth_tpu_torch.config import Config
from cadepth_tpu_torch.data.sunrgbd import SunRGBDLoader
from cadepth_tpu_torch.models.factory import (check_input_size,
                                              create_model, resolve_device)
from cadepth_tpu_torch.training.train_state import _inputs, make_predict_fn
from cadepth_tpu_torch.utils.profiling import span


def load_exported(path: str) -> Callable[[Mapping], torch.Tensor]:
    """Read back a :meth:`Predictor.export` program.

    Returns ``fn(batch) -> depth``: ``batch`` is the dict the program was
    exported with ('rgb', 'intrinsics', 'k4', and 'rays' where the config
    does not derive rays from K) at its shapes, tensors on its device
    (numpy arrays are moved there); the parameters are held in the
    program, so no model code, config or checkpoint is needed.
    """
    # the warps' registered ops must exist before the program is read
    from cadepth_tpu_torch.ops import fused_warp, two_pass_warp  # noqa: F401

    program = torch.export.load(path)
    module = program.module()
    device = next(iter(program.state_dict.values())).device

    def fn(batch: Mapping) -> torch.Tensor:
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        with torch.no_grad():
            return module(batch)

    return fn


class _PredictModule(torch.nn.Module):
    """``make_predict_fn``'s forward as a module, for ``torch.export``:
    rays from K on the device (where the config derives them), then the
    model in eval mode."""

    def __init__(self, cfg: Config, model: torch.nn.Module):
        super().__init__()
        self.cfg = cfg
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.model(*_inputs(self.cfg, batch))


def _default_k4(batch: int, height: int, width: int) -> np.ndarray:
    """Centered pinhole with f = width (cli/infer.py convention)."""
    k4 = np.empty((batch, 4), np.float32)
    k4[:, 0] = width
    k4[:, 1] = width
    k4[:, 2] = width / 2.0
    k4[:, 3] = height / 2.0
    return k4


def _matrix(k4: np.ndarray) -> np.ndarray:
    k = np.tile(np.eye(3, dtype=np.float32), (k4.shape[0], 1, 1))
    k[:, 0, 0], k[:, 1, 1] = k4[:, 0], k4[:, 1]
    k[:, 0, 2], k[:, 1, 2] = k4[:, 2], k4[:, 3]
    return k


class Predictor:
    """Fixed-shape depth predictor over the config's model.

    ``device`` is ``"cuda"`` unless the caller asks for ``"cpu"``; where
    CUDA is asked for and absent, construction raises. Compute runs in
    bf16 over fp32 parameters when ``cfg.training.use_amp`` is set, as
    in the JAX package.
    """

    def __init__(self, cfg: Config,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 batch_size: int = 1, height: Optional[int] = None,
                 width: Optional[int] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        # with data.compute_rays the forward derives the ray grid from K
        # on the device; without it, requests carry host ray grids, as
        # the host loader makes them
        self._derive_rays = bool(cfg.data.compute_rays)
        self.batch_size = batch_size
        self.height = height or cfg.data.input_height
        self.width = width or cfg.data.input_width
        self.architecture = cfg.model.architecture
        check_input_size(self.architecture, self.height, self.width)
        m = cfg.model
        # with a state_dict, the model is laid out on the meta device and
        # filled from it: no weights are drawn only to be replaced
        with torch.device("meta") if state_dict is not None \
                else contextlib.nullcontext():
            model = create_model(
                m.architecture, in_channels=m.in_channels,
                init_features=m.init_features, camera_dim=m.camera_dim,
                max_depth=m.max_depth, use_pcl=m.use_pcl,
                use_attention=m.use_attention, variant=m.variant,
                pcl_warp=m.pcl_warp, norm=m.norm,
                decoder_upsample=m.decoder_upsample,
                sa_lowering=m.sa_lowering,
                dtype=torch.bfloat16 if cfg.training.use_amp
                else torch.float32,
                device=self.device if state_dict is None else "meta",
                generator=generator)
        if state_dict is not None:
            model = model.to_empty(device=self.device)
            model.load_state_dict(state_dict)
        self.model = model
        self._predict = make_predict_fn(cfg, self.model)
        self._default_k_dev: Optional[Dict[str, torch.Tensor]] = None
        # requests handed over, the trace ids of their spans
        self._requests = 0

    @classmethod
    def from_checkpoint(cls, cfg: Config, checkpoint: str = "best",
                        batch_size: int = 1, height: Optional[int] = None,
                        width: Optional[int] = None,
                        device="cuda") -> "Predictor":
        """Restore a checkpoint of the port's trainer from
        ``checkpoint_dir/<experiment name>``: "best", "latest" or a path
        (``CheckpointManager.resolve``; FileNotFoundError where there is
        none). The model's ``state_dict`` is read on the CPU and moved to
        ``device``."""
        from cadepth_tpu_torch.training.checkpoint import CheckpointManager

        mgr = CheckpointManager(str(Path(cfg.checkpointing.checkpoint_dir)
                                    / cfg.experiment.name))
        state = mgr.restore(mgr.resolve(checkpoint), map_location="cpu")
        return cls(cfg, state["model"], batch_size=batch_size, height=height,
                   width=width, device=device)

    # -- serving ------------------------------------------------------------

    def _make_batch(self, rgb: np.ndarray, intrinsics: Optional[np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
        n, h, w = rgb.shape[0], self.height, self.width
        if rgb.shape[1:3] != (h, w):
            raise ValueError(
                f"Predictor built for {h}x{w}, got {rgb.shape[1:3]}; "
                "resize on the client or build another Predictor")
        if n > self.batch_size:
            raise ValueError(f"got {n} samples > batch_size {self.batch_size}")
        with span("serve.pad"):
            rgb_full = np.zeros((self.batch_size, h, w, 3), np.float32)
            rgb_full[:n] = rgb
            if intrinsics is None:
                k4 = _default_k4(self.batch_size, h, w)
                k = _matrix(k4)
            else:
                k = np.tile(np.eye(3, dtype=np.float32),
                            (self.batch_size, 1, 1))
                k[:n] = intrinsics
                if n < self.batch_size:
                    k[n:] = intrinsics[-1]
                k4 = np.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2],
                               k[:, 1, 2]], -1).astype(np.float32)
            batch = {"rgb": rgb_full, "intrinsics": k.astype(np.float32),
                     "k4": k4}
            if not self._derive_rays:
                batch["rays"] = np.stack(
                    [SunRGBDLoader._compute_rays(k[i], h, w)
                     for i in range(self.batch_size)]).astype(np.float32)
        with span("serve.h2d") as h2d:
            h2d.set(bytes=sum(v.nbytes for v in batch.values()))
            return {key: torch.from_numpy(v).to(self.device)
                    for key, v in batch.items()}

    def _device_batch(self, rgb: torch.Tensor,
                      intrinsics: Optional[torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        if not self._derive_rays:
            raise ValueError("device-input path needs data.compute_rays "
                             "(rays are derived on the device)")
        want = (self.batch_size, self.height, self.width, 3)
        if tuple(rgb.shape) != want:
            raise ValueError(f"device input must be the predictor's shape "
                             f"{want}, got {tuple(rgb.shape)}")
        if rgb.dtype != torch.float32:
            raise ValueError(f"device input must be float32, got {rgb.dtype}")
        if rgb.device != self.device:
            raise ValueError(f"device input must be on {self.device}, "
                             f"got {rgb.device}")
        if intrinsics is None:
            if self._default_k_dev is None:
                k4 = _default_k4(self.batch_size, self.height, self.width)
                self._default_k_dev = {
                    "intrinsics": torch.from_numpy(_matrix(k4)).to(self.device),
                    "k4": torch.from_numpy(k4).to(self.device)}
            return {"rgb": rgb, **self._default_k_dev}
        if tuple(intrinsics.shape) != (want[0], 3, 3):
            raise ValueError(f"device intrinsics must be ({want[0]}, 3, 3), "
                             f"got {tuple(intrinsics.shape)}")
        if intrinsics.dtype != torch.float32:
            raise ValueError(f"device intrinsics must be float32, "
                             f"got {intrinsics.dtype}")
        k4 = torch.stack([intrinsics[:, 0, 0], intrinsics[:, 1, 1],
                          intrinsics[:, 0, 2], intrinsics[:, 1, 2]], -1)
        return {"rgb": rgb, "intrinsics": intrinsics, "k4": k4}

    def _run(self, rgb, intrinsics):
        """Enqueue one forward; returns (depth on the device, n real rows)."""
        if isinstance(rgb, torch.Tensor):
            batch, n = self._device_batch(rgb, intrinsics), rgb.shape[0]
        else:
            rgb = np.asarray(rgb, np.float32)
            if rgb.ndim == 3:
                rgb = rgb[None]
            batch, n = self._make_batch(rgb, intrinsics), rgb.shape[0]
        with span("serve.forward", device=self.device):
            return self._predict(batch), n

    def _submit(self, rgb, intrinsics):
        """``_run`` as request span ``serve.request``; returns (depth on the
        device, n real rows, the request's span)."""
        self._requests += 1
        request = span("serve.request", trace=self._requests)
        with request.active():
            out, n = self._run(rgb, intrinsics)
        return out, n, request

    @staticmethod
    def _answer(out: torch.Tensor, n: int, request) -> np.ndarray:
        """The depth of a forward ``_submit`` enqueued, on the host."""
        with span("serve.readback", parent=request) as readback:
            depth = out[:n].cpu().numpy()
            readback.set(bytes=depth.nbytes)
        request.close()
        return depth

    def predict(self, rgb, intrinsics=None) -> np.ndarray:
        """rgb (N, H, W, 3) float in [0, 1], optional K (N, 3, 3) ->
        depth (N, H, W, 1) metres, as numpy.

        ``rgb`` may also be a float32 tensor already on the predictor's
        device at its (batch_size, H, W, 3) shape, with ``intrinsics`` a
        (batch_size, 3, 3) tensor there or None: no host staging then.
        """
        return self._answer(*self._submit(rgb, intrinsics))

    def predict_stream(self, requests: Iterable, depth: int = 2
                       ) -> Iterator[np.ndarray]:
        """Pipelined serving over an iterable of requests.

        Each request is ``rgb`` or ``(rgb, intrinsics)``. Up to ``depth``
        forwards are enqueued before the oldest answer is read back, so
        the host stages request k+1 while the card still runs request k.
        Yields (N, H, W, 1) numpy depth maps in request order.
        """
        inflight: deque = deque()
        for req in requests:
            rgb, k = req if isinstance(req, tuple) else (req, None)
            inflight.append(self._submit(rgb, k))
            while len(inflight) >= max(depth, 1):
                yield self._answer(*inflight.popleft())
        while inflight:
            yield self._answer(*inflight.popleft())

    # -- deployment artifact ------------------------------------------------

    def export(self, path: str) -> int:
        """Write the predict program, parameters and buffers included, to
        ``path`` with ``torch.export`` (read it back with
        :func:`load_exported`). The program takes the batch dict at this
        predictor's shapes on its device. Returns the bytes written."""
        zeros = np.zeros((self.batch_size, self.height, self.width, 3),
                         np.float32)
        batch = self._make_batch(zeros, None)
        module = _PredictModule(self.cfg, self.model).eval()
        # without grad the warps take their registered forward ops, which
        # trace through their fake versions
        with torch.no_grad():
            program = torch.export.export(module, (batch,))
        torch.export.save(program, path)
        return os.path.getsize(path)

    # -- performance --------------------------------------------------------

    def benchmark(self, iterations: int = 50,
                  warmup: int = 5) -> Dict[str, float]:
        """Latency distribution of one full-batch forward, each timed on
        the host clock up to the read-back of its depth map."""
        rng = np.random.default_rng(0)
        batch = self._make_batch(
            rng.uniform(0, 1, (self.batch_size, self.height, self.width, 3))
            .astype(np.float32), None)
        for _ in range(warmup):
            out = self._predict(batch)
        out.cpu()
        times = []
        for _ in range(iterations):
            t0 = time.perf_counter()
            self._predict(batch).cpu()
            times.append((time.perf_counter() - t0) * 1000.0)
        arr = np.asarray(times)
        return {
            "batch_size": float(self.batch_size),
            "mean_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "p99_ms": float(np.percentile(arr, 99)),
            "images_per_sec": float(self.batch_size * 1000.0 / arr.mean()),
        }
