"""Training orchestration: epochs, validation, logging, checkpoints (port
of ``cadepth_tpu.training.trainer``).

The loop is the JAX trainer's: the host input pipeline prefetches batches
onto the device, each step's log scalars stay on the device and are read
only at ``log_interval`` (and the epoch's losses once, as one stacked
mean at its end), validation averages the eval step's metrics, then the
CSV row, TensorBoard scalars, image panels and histograms, best-metric
tracking, early stopping, periodic / best / final checkpoints, resume
from ``checkpointing.resume_from`` and a checkpoint at the next batch
boundary after SIGTERM.

The JAX state's ``step`` is ``TrainStep.updates`` (micro-steps), and the
learning rate it logs is ``schedule(step // grad_accum_steps)``.

With ``data.device_resident`` the batches come from the GPU-resident
feed (``data/device_resident.py``): the pack uploaded once, each batch
gathered and augmented on the device.

Data parallel: started in a process group (``torchrun ... --multihost``,
``parallel/distributed.py``) with ``hardware.data_parallel``, each of the
W ranks drives one card, feeds ``batch_size / W`` rows of every global
batch (the host pipeline's process slice, or its shard of the device
feed) and trains a replica through the data-parallel steps
(``training/train_state.py``), so every rank holds the same state and
metrics. Only rank 0 writes ``training.log``, the CSV, TensorBoard and
checkpoints; the others wait for each checkpoint at a barrier. A SIGTERM
on any rank stops every rank at the same batch boundary.

Spatial parallelism (``hardware.spatial_parallel`` S > 1 in a group of W
ranks): D = W / S data rows of S ranks (``parallel.make_mesh_2d``). The
feeds give each data row its ``batch_size / D`` samples, augmented on
the whole image (a crop and a flip change K), and each rank of the row
takes its band of H / S rows of them (``parallel.band_batch``); the
steps are the data-parallel ones over the W ranks. The image panels are
predicted on bands by every rank and gathered whole before rank 0 draws
them. Without a process group, S > 1 trains whole images on the one
card, as JAX's trainer does on one device.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist

from cadepth_tpu_torch.config import Config
from cadepth_tpu_torch.convert import to_jax
from cadepth_tpu_torch.data.pipeline import InputPipeline
from cadepth_tpu_torch.data.sunrgbd import AugmentationConfig, SunRGBDLoader
from cadepth_tpu_torch.metrics.depth_metrics import MetricsAccumulator
from cadepth_tpu_torch.models.factory import count_parameters, resolve_device
from cadepth_tpu_torch.parallel.mesh import (DataParallel, band_batch,
                                             make_mesh_2d, replicate_state)
from cadepth_tpu_torch.training.checkpoint import CheckpointManager
from cadepth_tpu_torch.training.schedule import build_lr_schedule
from cadepth_tpu_torch.training.tb_logger import TensorBoardLogger
from cadepth_tpu_torch.training.train_state import (
    build_model_and_loss,
    build_optimizer,
    device_batch,
    make_eval_step,
    make_grad_fn,
    make_predict_fn,
    make_train_step,
)
from cadepth_tpu_torch.utils.profiling import StepTimer, span
from cadepth_tpu_torch.visualization.depth_viz import create_comparison

CSV_HEADER = ("epoch,step,train_loss,val_loss,"
              "abs_rel,sq_rel,rmse,rmse_log,a1,a2,a3,"
              "learning_rate,time_elapsed\n")  # tensorboard_trainer_enhanced.h:111-115


def build_loaders(cfg: Config):
    """Train/val loaders + augmentation wiring (train_main.cpp:370-404)."""
    aug = cfg.data.augmentation
    sensors = cfg.data.sensor_types or ["kv1", "kv2", "realsense", "xtion"]
    common = dict(
        target_height=cfg.data.input_height,
        target_width=cfg.data.input_width,
        allowed_sensors=sensors,
        split_filtering=cfg.data.split_filtering,
        compute_rays=cfg.data.compute_rays,
        # the steps derive rays on the device when compute_rays, so host
        # batches skip the grid (and its copy to the device) entirely
        rays_on_device=cfg.data.compute_rays,
    )
    if cfg.data.packed_dir:
        from cadepth_tpu_torch.data.packed import PackedSunRGBDLoader

        common["preload"] = cfg.data.packed_preload
        train_loader = PackedSunRGBDLoader(
            cfg.data.packed_dir, split=cfg.data.train_split, **common)
        val_loader = PackedSunRGBDLoader(
            cfg.data.packed_dir, split=cfg.data.val_split, **common)
    else:
        common.update(data_dir=cfg.data.data_dir,
                      manifest_path=cfg.data.manifest_path)
        train_loader = SunRGBDLoader(split=cfg.data.train_split, **common)
        val_loader = SunRGBDLoader(split=cfg.data.val_split, **common)
    train_loader.enable_augmentation(AugmentationConfig(
        enable_random_crop=aug.random_crop,
        crop_scale_min=aug.crop_scale_min,
        crop_scale_max=aug.crop_scale_max,
        enable_horizontal_flip=aug.horizontal_flip,
        horizontal_flip_prob=aug.flip_probability,
        enable_color_jitter=aug.color_jitter,
        brightness_delta=aug.brightness,
        contrast_delta=aug.contrast,
        random_seed=cfg.experiment.seed,
    ))
    return train_loader, val_loader


def data_parallel_group(cfg: Config, device: torch.device
                        ) -> Optional[DataParallel]:
    """The data-parallel group to train in, by the JAX trainer's rule for
    processes: with ``hardware.data_parallel`` and a process group, its W
    ranks, where ``hardware.num_devices`` (0 = any) must be W and W must
    divide ``training.batch_size`` (the global batch); else None. A group
    of one gives None too: its steps are the single process's bit for
    bit, and each collective would cost host time for nothing.

    A run that sees several cards, with ``hardware.data_parallel`` and no
    ``num_devices: 1``, but was started outside a process group raises:
    it never trains on one card of several unasked. So does a group of
    several ranks without ``hardware.data_parallel`` (each would train a
    copy of its own).

    With ``hardware.spatial_parallel`` S > 1 the group is
    ``make_mesh_2d(W, S)``: W must divide by S, ``training.batch_size``
    by the W / S data rows and ``data.input_height`` by S, else this
    raises. (JAX's trainer drops devices until its rule holds and, where
    it cannot, trains on one device without a word.) A process without a
    group trains whole images, as JAX on one device."""
    hw = cfg.hardware
    if not dist.is_initialized():
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        if hw.data_parallel and cards > 1 and hw.num_devices != 1:
            raise RuntimeError(
                f"{cards} cards are visible but this process was not "
                "started in a process group; launch one process a card: "
                f"torchrun --nproc-per-node {cards} -m "
                "cadepth_tpu_torch.cli.train --multihost --config ... (or "
                "set hardware.num_devices: 1, or make one card visible)")
        return None
    world = dist.get_world_size()
    if not hw.data_parallel:
        if world > 1:
            raise ValueError(
                f"hardware.data_parallel is false but {world} processes "
                "were started in a group")
        return None
    spatial = max(hw.spatial_parallel, 1)
    if world == 1 and hw.num_devices in (0, 1):
        return None
    if world % spatial != 0:
        raise ValueError(
            f"hardware.spatial_parallel {spatial} does not divide the "
            f"process group's {world} ranks (data x space needs "
            "W % spatial_parallel == 0)")
    rows = world // spatial
    if cfg.training.batch_size % rows != 0:
        what = (f"the {rows} data rows of {world} ranks at "
                f"spatial_parallel {spatial}" if spatial > 1
                else f"hardware.num_devices {world}")
        raise ValueError(f"batch_size {cfg.training.batch_size} is not "
                         f"divisible by {what}")
    if cfg.data.input_height % spatial != 0:
        raise ValueError(
            f"data.input_height {cfg.data.input_height} is not divisible "
            f"by hardware.spatial_parallel {spatial} (each rank holds "
            "input_height / spatial_parallel rows)")
    # raises on another num_devices
    return make_mesh_2d(hw.num_devices, spatial)


def _flat_jax(named: Dict[str, torch.Tensor]):
    """(flax path, numpy array in the flax layout) of each parameter, in
    JAX's order (sorted paths); for a network with no flax layout
    (``depth_anything_v2``), its own names with ``/`` for ``.``."""
    try:
        params, _ = to_jax(named)
    except KeyError:
        return [(k.replace(".", "/"), v.detach().float().cpu().numpy())
                for k, v in sorted(named.items())]

    def walk(tree, prefix=()):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                yield from walk(tree[key], prefix + (key,))
            else:
                yield "/".join(prefix + (key,)), tree[key]

    return list(walk(params))


class Trainer:
    def __init__(self, cfg: Config,
                 train_loader: Optional[SunRGBDLoader] = None,
                 val_loader: Optional[SunRGBDLoader] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dp = data_parallel_group(cfg, self.device)
        self.rank0 = self.dp is None or self.dp.rank == 0
        if train_loader is None or val_loader is None:
            train_loader, val_loader = build_loaders(cfg)
        self.train_loader = train_loader
        self.val_loader = val_loader

        # -- pipelines
        debug_limits = getattr(cfg, "_debug_limits", None) or {}
        if cfg.data.device_resident:
            self._build_device_pipes(debug_limits)
        else:
            self._build_host_pipes(debug_limits)
        self._finish_init()

    def _build_device_pipes(self, debug_limits) -> None:
        """The pack held in device memory, batches gathered and augmented
        on the device (data.device_resident).

        Requires a pack at the target resolution; the train/val splits
        share one upload when their filtered rows coincide (the default
        non-filtering quirk makes them identical)."""
        from cadepth_tpu_torch.data.device_resident import (
            ChunkedDeviceDataset,
            DeviceDataset,
            DevicePipeline,
        )
        from cadepth_tpu_torch.data.packed import PackedSunRGBDLoader

        cfg = self.cfg
        if not isinstance(self.train_loader, PackedSunRGBDLoader):
            raise ValueError(
                "data.device_resident needs data.packed_dir (build one "
                "with cli/pack_dataset.py)")
        # "quantized" = the dataset's native encodings (rgb uint8, depth
        # uint16 millimeters): 3.2x less device memory than fp32, and depth
        # stores its exact mm value for mm-sourced packs — unlike bfloat16,
        # which is why bf16 storage never applies to the ground truth.
        if cfg.data.device_resident_dtype == "quantized":
            ds_kw = dict(rgb_dtype=torch.uint8, depth_dtype=torch.uint16)
        else:
            ds_kw = dict(rgb_dtype=(
                torch.bfloat16 if cfg.data.device_resident_dtype ==
                "bfloat16" else torch.float32), depth_dtype=torch.float32)
        ds_kw["device"] = self.device
        # each data row's shard (under spatial parallelism the ranks of a
        # row hold the same samples)
        ds_kw["mesh"] = None if self.dp is None else \
            DataParallel(self.dp.data_size, self.dp.data_rank)
        chunk = cfg.data.device_resident_chunk_samples
        # both splits' stores built: the host's gather or encode of the
        # pack's rows and their copies to the card
        with span("setup.store", always=True) as store:
            if chunk > 0:
                # pack bigger than device memory: rotate it through two
                # chunk buffers (same epoch semantics as fully-resident,
                # see the class)
                train_ds = ChunkedDeviceDataset(self.train_loader, chunk,
                                                **ds_kw)
                val_ds = ChunkedDeviceDataset(self.val_loader, chunk, **ds_kw)
                stored = train_ds.nbytes() + val_ds.nbytes()
            else:
                train_ds = DeviceDataset(self.train_loader, **ds_kw)
                stored = train_ds.nbytes()
                if [s["row"] for s in self.val_loader.sample_paths] == \
                        list(train_ds.rows):
                    # one upload serves both splits; the explicit
                    # constructor keeps split/augmentation identity per
                    # instance
                    val_ds = DeviceDataset(self.val_loader,
                                           share_storage_from=train_ds)
                else:
                    val_ds = DeviceDataset(self.val_loader, **ds_kw)
                    stored += val_ds.nbytes()
            store.set(bytes=stored)
        self.train_pipe = DevicePipeline(
            train_ds, cfg.training.batch_size, shuffle=True,
            seed=cfg.experiment.seed,
            max_samples=debug_limits.get("num_train_samples"))
        self.val_pipe = DevicePipeline(
            val_ds, cfg.training.batch_size, shuffle=False,
            seed=cfg.experiment.seed,
            max_samples=debug_limits.get(
                "num_val_samples", cfg.training.max_val_samples))

    def _build_host_pipes(self, debug_limits) -> None:
        cfg = self.cfg
        self.train_pipe = InputPipeline(
            self.train_loader, cfg.training.batch_size, shuffle=True,
            seed=cfg.experiment.seed,
            num_threads=max(cfg.training.num_workers, 1),
            prefetch_depth=cfg.training.prefetch_factor,
            max_samples=debug_limits.get("num_train_samples"),
            use_native=cfg.data.use_native_loader, device=self.device,
            **self._process_slice())
        # Validation capped at max_val_samples (production_trainer.h:242-281).
        # drop_remainder keeps eval batch shapes static; up to
        # batch_size-1 tail samples are skipped per pass.
        self.val_pipe = InputPipeline(
            self.val_loader, cfg.training.batch_size, shuffle=False,
            seed=cfg.experiment.seed,
            num_threads=max(cfg.training.num_workers, 1),
            prefetch_depth=cfg.training.prefetch_factor,
            max_samples=debug_limits.get(
                "num_val_samples", cfg.training.max_val_samples),
            use_native=cfg.data.use_native_loader, device=self.device,
            **self._process_slice())

    def _process_slice(self) -> Dict[str, int]:
        if self.dp is None:
            return {}
        return {"process_index": self.dp.data_rank,
                "process_count": self.dp.data_size}

    def _finish_init(self) -> None:
        cfg = self.cfg
        # -- model / optimizer / steps
        with span("setup.model", always=True):
            self.model, self.loss_fn = build_model_and_loss(
                cfg, device=self.device,
                generator=torch.Generator().manual_seed(cfg.experiment.seed),
                dp=self.dp)
            # With grad accumulation the schedule advances only on
            # effective updates (optax.MultiSteps), so express epochs in
            # update counts.
            accum = max(cfg.optimization.grad_accum_steps, 1)
            steps_per_epoch = max(len(self.train_pipe) // accum, 1)
            self.lr_schedule = build_lr_schedule(
                cfg.optimization, steps_per_epoch, cfg.training.num_epochs)
            self.optimizer = build_optimizer(cfg.optimization,
                                             self.model.parameters())
            self.train_step = make_train_step(cfg, self.model, self.loss_fn,
                                              self.optimizer,
                                              self.lr_schedule)
            self.eval_step = make_eval_step(cfg, self.model, self.loss_fn)
            self.predict_fn = make_predict_fn(cfg, self.model)
        # built lazily: runs only if histogram logging ever fires
        self._grad_fn = None
        self._last_train_batch = None
        self.num_params = count_parameters(self.model)

        # -- observability (rank 0's alone under a group)
        log_dir = Path(cfg.logging.log_dir) / cfg.experiment.name
        self.log_dir = log_dir
        self.tb = TensorBoardLogger(
            str(log_dir / "tensorboard"),
            enabled=cfg.logging.tensorboard_enabled and self.rank0)
        self._train_log = None
        self._csv = None
        if self.rank0:
            log_dir.mkdir(parents=True, exist_ok=True)
            self._train_log = open(log_dir / "training.log", "a")
        if cfg.logging.csv_enabled and self.rank0:
            self._csv = open(log_dir / cfg.logging.metrics_file, "a")
            if self._csv.tell() == 0:
                self._csv.write(CSV_HEADER)

        # -- checkpointing / early stopping
        self.ckpt = CheckpointManager(
            str(Path(cfg.checkpointing.checkpoint_dir) / cfg.experiment.name),
            keep_last_n=cfg.checkpointing.keep_last_n,
            metric_name=cfg.validation.primary_metric,
            metric_lower_is_better=cfg.validation.metric_mode == "min")
        self.start_epoch = 0
        self.best_metric = float("inf") if cfg.validation.metric_mode == "min" \
            else float("-inf")
        self.epochs_without_improvement = 0
        self.history: list = []
        # When set, train() wraps the FIRST epoch in a torch.profiler
        # trace: profiled runs take the same optimizer/LR trajectory as
        # unprofiled ones (no separate throwaway epoch).
        self.profile_dir: Optional[str] = None

        # -- preemption safety: on SIGTERM finish the in-flight batch,
        # checkpoint, and exit cleanly so --resume latest continues where
        # it stopped.
        self._preempted = False
        self._orig_sigterm = None
        if cfg.checkpointing.save_on_preemption:
            import signal
            import threading

            def _on_sigterm(signum, frame):
                self._preempted = True
                self.log("SIGTERM received; checkpointing at the next "
                         "batch boundary")

            if threading.current_thread() is threading.main_thread():
                self._orig_sigterm = signal.signal(signal.SIGTERM,
                                                   _on_sigterm)

        resume_from = cfg.checkpointing.resume_from
        if resume_from:
            path = resume_from if resume_from != "latest" \
                else self.ckpt.latest_checkpoint()
            if path:
                state, meta = self.ckpt.restore_with_meta(path, self.device)
                self.train_step.load_state_dict(state)
                self.start_epoch = int(meta.get("epoch", 0)) + 1
                metrics = meta.get("metrics", {})
                # Seed best_metric from BOTH the resumed checkpoint and the
                # stored best/ checkpoint: resuming from 'latest' (which may
                # be worse than best/) must not let a mediocre later epoch
                # overwrite the true best model.
                candidates = []
                if self.cfg.validation.primary_metric in metrics:
                    candidates.append(
                        float(metrics[self.cfg.validation.primary_metric]))
                stored_best = self.ckpt.best_metric_value()
                if stored_best is not None:
                    candidates.append(stored_best)
                if candidates:
                    pick = min if cfg.validation.metric_mode == "min" else max
                    self.best_metric = pick(candidates)
                self.log(f"Resumed from {path} at epoch {self.start_epoch}")
        if self.dp is not None:
            replicate_state(self.train_step, self.dp)

    # -- logging helpers ------------------------------------------------------

    def log(self, message: str) -> None:
        if self._train_log is None:
            return
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{stamp}] {message}"
        if self.cfg.logging.verbose:
            print(line, flush=True)
        self._train_log.write(line + "\n")
        self._train_log.flush()

    def _is_improvement(self, value: float) -> bool:
        delta = self.cfg.early_stopping.min_delta
        if self.cfg.validation.metric_mode == "min":
            return value < self.best_metric - delta
        return value > self.best_metric + delta

    def _stop_agreed(self) -> bool:
        """Whether to stop at this batch boundary for a SIGTERM: this
        process's, or under a group any rank's (every rank asks at the
        same boundaries, so all stop at the same one)."""
        if self.dp is not None:
            self._preempted = self.dp.any(self._preempted)
        return self._preempted

    def _save(self, epoch: int, metrics: Dict[str, float], is_best: bool,
              blocking: bool) -> None:
        """A checkpoint, written by rank 0 (blocking under a group) while
        the other ranks wait, so a resume finds it whole."""
        if self.rank0:
            self.ckpt.save(self.train_step.state_dict(), epoch, metrics,
                           is_best=is_best,
                           blocking=blocking or self.dp is not None)
        if self.dp is not None:
            self.dp.barrier()

    # -- loops ------------------------------------------------------------

    def train_epoch(self, epoch: int) -> float:
        cfg = self.cfg
        log_interval = max(cfg.training.log_interval, 1)
        losses = []
        last_logs = None
        timer = StepTimer()
        batches = iter(self.train_pipe)
        batch_idx = -1
        while True:
            # the batch the next step takes: its trace id is that step's
            with span("train.feed", device=self.device,
                      trace=self.train_step.updates):
                batch = next(batches, None)
            if batch is None:
                break
            batch_idx += 1
            if self._stop_agreed():
                break
            batch = band_batch(batch, self.dp)
            logs = self.train_step(batch)
            if self.cfg.logging.log_histogram_interval:
                # kept ONLY when gradient histograms will read it: a full
                # batch held in device memory
                self._last_train_batch = batch
            timer.step(cfg.training.batch_size)
            losses.append(logs["total_loss"])
            last_logs = logs
            if batch_idx % log_interval == 0:
                step = self.train_step.updates
                # the reads wait for the card to finish this step (whose
                # trace id is the count before it)
                with span("train.log_read", trace=step - 1):
                    self.tb.add_scalar("batch_loss/train",
                                       float(logs["total_loss"]), step)
                    self.tb.add_scalar("training/gradient_norm",
                                       float(logs["grad_norm"]), step)
                    # gradients/{norm,max,min} tag parity
                    # (tensorboard_trainer_enhanced.h:523-555)
                    self.tb.add_scalar("gradients/norm",
                                       float(logs["grad_norm"]), step)
                    self.tb.add_scalar("gradients/max",
                                       float(logs["grad_max"]), step)
                    self.tb.add_scalar("gradients/min",
                                       float(logs["grad_min"]), step)
        if not losses:
            return 0.0
        with span("train.epoch_end", trace=self.train_step.updates):
            if timer.steps > 0:
                self.tb.add_scalar("training/images_per_sec",
                                   timer.rate(self.device), epoch)
            mean_loss = float(torch.stack(losses).mean())
            if last_logs is not None:
                step = self.train_step.updates
                for key in ("si_loss", "grad_loss", "smooth_loss",
                            "reproj_loss"):
                    if key in last_logs:
                        self.tb.add_scalar(
                            f"loss_components/{key.removesuffix('_loss')}",
                            float(last_logs[key]), step)
        return mean_loss

    def validate(self, epoch: int) -> Dict[str, float]:
        acc = MetricsAccumulator()
        for batch in self.val_pipe:
            out = self.eval_step(band_batch(batch, self.dp))
            acc.update({k: float(v) for k, v in out.items()})
        return acc.average()

    def visualize(self, epoch: int) -> None:
        """Log [RGB | GT | Pred | Error] panels (tensorboard_trainer_enhanced.h:444-470)."""
        n = min(self.cfg.training.num_vis_samples, len(self.val_loader))
        space = None if self.dp is None else self.dp.space
        if n == 0 or not self.cfg.training.save_predictions or \
                not (self.rank0 or space is not None):
            return
        batch = self.val_loader.get_batch(range(n))
        pred = self.predict_fn(band_batch(device_batch(batch, self.device),
                                          self.dp))
        if space is not None:
            # every rank predicted its band; rank 0 draws the whole maps
            pred = space.gather(pred, 1)
            if not self.rank0:
                return
        pred = pred.float().cpu().numpy()
        for i in range(n):
            panel = create_comparison(batch["rgb"][i], batch["depth"][i],
                                      pred[i])
            self.tb.add_image(f"predictions/sample_{i}", panel, epoch)

    def log_weight_histograms(self, epoch: int) -> None:
        named = {n: p.detach() for n, p in self.model.named_parameters()}
        for name, leaf in _flat_jax(named):
            self.tb.add_histogram(f"weights/{name}", leaf, epoch)

    def log_gradient_histograms(self, epoch: int) -> None:
        """Per-parameter `gradients/<name>` histograms
        (`tensorboard_trainer_enhanced.h:523-555`), from a gradient-only
        pass on the epoch's last train batch."""
        if self._last_train_batch is None:
            return
        if self._grad_fn is None:
            self._grad_fn = make_grad_fn(self.cfg, self.model, self.loss_fn)
        grads = self._grad_fn(self._last_train_batch)
        for name, leaf in _flat_jax(grads):
            self.tb.add_histogram(f"gradients/{name}", leaf, epoch)

    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        self.log("=" * 55)
        self.log(f"cadepth_tpu_torch trainer — experiment "
                 f"'{cfg.experiment.name}'")
        self.log(f"model={cfg.model.architecture} params={self.num_params:,}")
        self.log(f"device={self.device} batch={cfg.training.batch_size}"
                 + (f" over {self.dp.world_size} ranks"
                    if self.dp is not None else "")
                 + (f" ({self.dp.data_size} data rows x "
                    f"{self.dp.space.size} bands of "
                    f"{cfg.data.input_height // self.dp.space.size} rows)"
                    if self.dp is not None and self.dp.space is not None
                    else ""))
        self.log(f"train_samples={len(self.train_loader)} "
                 f"val_samples={len(self.val_loader)}")
        self.log("=" * 55)
        self.tb.add_custom_scalars_layout()
        self.tb.add_text("model/architecture",
                         f"{cfg.model.architecture} ({self.num_params:,} params)")
        self.tb.add_hparams({
            "architecture": cfg.model.architecture,
            "init_features": cfg.model.init_features,
            "batch_size": cfg.training.batch_size,
            "learning_rate": cfg.optimization.learning_rate,
            "optimizer": cfg.optimization.optimizer,
            "lr_scheduler": cfg.optimization.lr_scheduler,
        })

        t0 = time.time()
        final_metrics: Dict[str, float] = {}
        for epoch in range(self.start_epoch, cfg.training.num_epochs):
            epoch_start = time.time()
            if self.profile_dir and epoch == self.start_epoch:
                from cadepth_tpu_torch.utils.profiling import profile_trace

                with profile_trace(self.profile_dir):
                    train_loss = self.train_epoch(epoch)
                self.log(f"Profile trace written to {self.profile_dir}")
            else:
                train_loss = self.train_epoch(epoch)
            if self._stop_agreed():
                self._save(epoch, {}, is_best=False, blocking=True)
                self.log(f"Preempted during epoch {epoch + 1}; checkpoint "
                         f"saved at step {self.train_step.updates} — resume "
                         "with --resume latest")
                break
            epoch_time = time.time() - epoch_start
            step = self.train_step.updates
            # step counts micro-steps; the schedule is indexed by effective
            # optimizer updates
            lr = float(self.lr_schedule(
                step // max(self.cfg.optimization.grad_accum_steps, 1)))

            self.tb.add_scalar("loss/train", train_loss, epoch)
            self.tb.add_scalar("training/learning_rate", lr, epoch)
            self.tb.add_scalar("training/epoch_time_seconds", epoch_time, epoch)
            self.tb.add_scalar("training/total_time_seconds",
                               time.time() - t0, epoch)

            val_metrics: Dict[str, float] = {}
            if (epoch + 1) % max(cfg.training.val_interval, 1) == 0:
                val_metrics = self.validate(epoch)
                final_metrics = val_metrics
                self.tb.add_scalar("loss/val",
                                   val_metrics.get("total_loss", 0.0), epoch)
                for name in ("abs_rel", "sq_rel", "rmse", "rmse_log"):
                    self.tb.add_scalar(f"metrics/{name}",
                                       val_metrics.get(name, 0.0), epoch)
                self.tb.add_scalar("metrics/a1",
                                   val_metrics.get("delta_1.25", 0.0), epoch)
                self.tb.add_scalar("metrics/a2",
                                   val_metrics.get("delta_1.25^2", 0.0), epoch)
                self.tb.add_scalar("metrics/a3",
                                   val_metrics.get("delta_1.25^3", 0.0), epoch)
                if "pcl_max_rot" in val_metrics:
                    # live check of the two_pass warp's sub-pixel bound
                    rot = val_metrics["pcl_max_rot"]
                    self.tb.add_scalar("training/pcl_max_rot", rot, epoch)
                    self.log(f"pcl_max_rot: {rot:.5f}")
                    from cadepth_tpu_torch.models.pcl import DEFAULT_ROT_BOUND
                    if cfg.model.pcl_warp in ("two_pass", "separable",
                                              "pallas", "fused") \
                            and rot > 0.8 * DEFAULT_ROT_BOUND:
                        self.log(
                            f"WARNING: pcl_max_rot={rot:.4f} approaches "
                            f"the {cfg.model.pcl_warp} warp's validated "
                            f"rotation bound ({DEFAULT_ROT_BOUND}); the "
                            "warp kernel displacement may exceed a pixel "
                            "— consider model.pcl_warp: auto (exact "
                            "gather fallback) for this workload")
                self.visualize(epoch)

            if cfg.logging.log_histogram_interval and \
                    (epoch + 1) % cfg.logging.log_histogram_interval == 0:
                self.log_weight_histograms(epoch)
                self.log_gradient_histograms(epoch)

            if self._csv is not None:
                self._csv.write(
                    f"{epoch},{step},{train_loss:.6f},"
                    f"{val_metrics.get('total_loss', 0.0):.6f},"
                    f"{val_metrics.get('abs_rel', 0.0):.6f},"
                    f"{val_metrics.get('sq_rel', 0.0):.6f},"
                    f"{val_metrics.get('rmse', 0.0):.6f},"
                    f"{val_metrics.get('rmse_log', 0.0):.6f},"
                    f"{val_metrics.get('delta_1.25', 0.0):.6f},"
                    f"{val_metrics.get('delta_1.25^2', 0.0):.6f},"
                    f"{val_metrics.get('delta_1.25^3', 0.0):.6f},"
                    f"{lr:.8f},{time.time() - t0:.1f}\n")
                self._csv.flush()

            primary = val_metrics.get(cfg.validation.primary_metric)
            is_best = primary is not None and self._is_improvement(primary)
            if is_best:
                self.best_metric = primary
                self.epochs_without_improvement = 0
            elif primary is not None:
                self.epochs_without_improvement += 1

            # save_best_only skips the periodic saves (train_config.yaml:140);
            # best and final-epoch checkpoints are always written.
            periodic = (not cfg.checkpointing.save_best_only
                        and (epoch + 1) % max(cfg.checkpointing.save_interval, 1) == 0)
            is_last = epoch == cfg.training.num_epochs - 1
            if periodic or is_best or (is_last and cfg.checkpointing.save_last):
                self._save(epoch, val_metrics, is_best,
                           blocking=not cfg.checkpointing.async_save)

            msg = (f"epoch {epoch + 1}/{cfg.training.num_epochs} "
                   f"loss={train_loss:.4f} lr={lr:.2e} time={epoch_time:.1f}s")
            if val_metrics:
                msg += (f" val_abs_rel={val_metrics.get('abs_rel', 0):.4f}"
                        f" val_rmse={val_metrics.get('rmse', 0):.4f}")
            self.log(msg)
            self.history.append({"epoch": epoch, "train_loss": train_loss,
                                 **val_metrics})

            if cfg.early_stopping.enabled and \
                    self.epochs_without_improvement >= cfg.early_stopping.patience:
                self.log(f"Early stopping at epoch {epoch + 1} "
                         f"(no improvement for "
                         f"{self.epochs_without_improvement} epochs)")
                break

        self.ckpt.finalize()  # land any in-flight async save
        self.log(f"Training complete in {time.time() - t0:.1f}s; "
                 f"best {cfg.validation.primary_metric}={self.best_metric:.4f}")
        self.tb.flush()
        return final_metrics

    def close(self) -> None:
        if self._orig_sigterm is not None:
            import signal

            signal.signal(signal.SIGTERM, self._orig_sigterm)
            self._orig_sigterm = None
        self.tb.close()
        if self._train_log is not None:
            self._train_log.close()
        if self._csv is not None:
            self._csv.close()
