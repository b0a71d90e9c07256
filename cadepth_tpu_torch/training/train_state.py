"""Train, gradient, eval and inference steps (port of
``cadepth_tpu.training.train_state``).

    model, loss_fn = build_model_and_loss(cfg)                # on "cuda"
    optimizer = build_optimizer(cfg.optimization, model.parameters())
    step = make_train_step(cfg, model, loss_fn, optimizer, schedule)
    logs = step(batch)                                        # one update

A batch is a dict of tensors on the model's device: 'rgb' (B, H, W, 3),
'depth' (B, H, W, 1), 'intrinsics' (B, 3, 3), 'k4' (B, 4), and 'rays'
(B, H, W, 3) where ``data.compute_rays`` is off.

The JAX step is one jitted program over an immutable state; here the
model's parameters and BN statistics and the optimizer's moments are
updated in place, and the step counts its updates itself. Logs are
0-dim tensors on the device, so a step does not wait for the card.

Data parallel: ``build_model_and_loss(cfg, dp=make_mesh())`` gives a
model whose batch norms and a loss whose terms cover the group's global
batch (``parallel/mesh.py``); each rank feeds its rows of it. The steps
read the group from ``loss_fn.dp``: the train step back-propagates
``loss / W`` and all-reduces the parameter gradients once per update (on
every call, or with ``grad_accum_steps`` k on the k-th, the running mean
of the k micro-batches), so every rank clips and updates with the same
gradient, as JAX's replicated state does; the eval step's metrics are
those of the global batch.

Spatial parallelism (``dp=make_mesh_2d(n, S)``): each rank is given its
band of each image (``parallel.shard_batch``, or a data row's batch
through ``parallel.band_batch``); the model (``model.space``) and the
loss work on bands, and the rays derived from K are those of the band's
rows. The steps are the data-parallel ones: every rank holds the global
loss, back-propagates it divided by W, and the W ranks' gradients sum to
the gradient of one process over the whole images.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from cadepth_tpu_torch.config import Config, OptimizationConfig
from cadepth_tpu_torch.geometry.rays import ray_grid_batch
from cadepth_tpu_torch.losses.depth_loss import CombinedDepthLoss
from cadepth_tpu_torch.metrics.depth_metrics import compute_depth_metrics
from cadepth_tpu_torch.models.factory import (check_input_size,
                                              create_model, model_inputs)
from cadepth_tpu_torch.models.layers import sync_batch_norms
from cadepth_tpu_torch.parallel.mesh import DataParallel
from cadepth_tpu_torch.utils.profiling import span

Batch = Dict[str, torch.Tensor]


def device_batch(batch: Dict[str, np.ndarray], device) -> Batch:
    """A host batch (numpy arrays, as a loader's ``get_batch`` gives it)
    as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _batch_with_rays(batch: Batch, needs_rays: bool, derive_rays: bool,
                     space=None) -> Batch:
    """Ensure geometry batches carry a ray grid: with ``derive_rays``
    (= data.compute_rays), or when the batch has none, derive it from K
    on the batch's device; on bands of ``space``, the band's rows of the
    image's grid."""
    if needs_rays and (derive_rays or "rays" not in batch):
        h, w = batch["rgb"].shape[1], batch["rgb"].shape[2]
        batch = dict(batch)
        batch["rays"] = ray_grid_batch(
            batch["intrinsics"], h, w,
            row0=0 if space is None else space.row0(h))
    return batch


def _inputs(cfg: Config, batch: Batch, space=None):
    arch = cfg.model.architecture
    b = _batch_with_rays(batch, arch.startswith("geometry_aware"),
                         cfg.data.compute_rays, space)
    return model_inputs(arch, b)


def build_model_and_loss(cfg: Config, device="cuda",
                         generator: Optional[torch.Generator] = None,
                         dp: Optional[DataParallel] = None):
    """(model, loss_fn) as the config says: bf16 compute over fp32
    parameters when ``training.use_amp`` is set, else float32; with
    ``dp``, batch norms and losses over the group's global batch, and
    under its ``space`` a model and a loss that take bands of the
    images. Raises where the architecture cannot take
    ``data.input_height`` x ``data.input_width`` images."""
    m = cfg.model
    check_input_size(m.architecture, cfg.data.input_height,
                     cfg.data.input_width)
    model = create_model(
        m.architecture, in_channels=m.in_channels,
        init_features=m.init_features, camera_dim=m.camera_dim,
        max_depth=m.max_depth, use_pcl=m.use_pcl,
        use_attention=m.use_attention, variant=m.variant,
        pcl_warp=m.pcl_warp, norm=m.norm,
        decoder_upsample=m.decoder_upsample, sa_lowering=m.sa_lowering,
        remat=m.remat,
        dtype=torch.bfloat16 if cfg.training.use_amp else torch.float32,
        device=device, generator=generator)
    sync_batch_norms(model, dp)
    model.space = None if dp is None else dp.space
    lc = cfg.loss
    loss_fn = CombinedDepthLoss(
        si_weight=lc.si_weight, grad_weight=lc.grad_weight,
        smooth_weight=lc.smooth_weight, reproj_weight=lc.reproj_weight,
        si_lambda=lc.si_lambda, grad_num_scales=lc.grad_num_scales, dp=dp)
    return model, loss_fn


# -- optimizer ---------------------------------------------------------------

def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> None:
    """optax.clip_by_global_norm, in place: ``g`` when the norm is below
    ``max_norm``, else ``g / norm * max_norm``. (torch's
    ``clip_grad_norm_`` adds 1e-6 to the norm and scales below the
    threshold too.) Decided on the device, so the host does not wait."""
    if norm is None:
        norm = global_norm(grads)
    under = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(under, one, norm))
    torch._foreach_mul_(grads, torch.where(under, one, one * max_norm))


@dataclasses.dataclass
class Optimizer:
    """optax's ``chain(clip_by_global_norm, adam | adamw | sgd)`` over a
    torch optimizer, wrapped in ``optax.MultiSteps`` when
    ``accum_steps`` > 1.

    :meth:`step` clips the gradients in place (when ``clip_value`` is
    set), sets the learning rate and updates. :meth:`update` takes one
    micro-batch's gradients: with ``accum_steps`` k > 1 it folds them into
    a running mean (MultiSteps' ``acc + (g - acc) / (n + 1)``) and, on
    every k-th call, steps on the mean; the other calls leave the
    parameters and the optimizer's state as they are. ``updates`` counts
    the steps taken, which the learning-rate schedule reads."""

    base: torch.optim.Optimizer
    clip_value: Optional[float] = None
    accum_steps: int = 1
    updates: int = 0
    # the running mean of this update's micro-batch gradients, and their
    # number
    _mean: Optional[List[torch.Tensor]] = dataclasses.field(
        default=None, init=False, repr=False)
    _micro: int = dataclasses.field(default=0, init=False, repr=False)

    def params(self) -> List[nn.Parameter]:
        return [p for g in self.base.param_groups for p in g["params"]]

    def step(self, lr: float, norm: Optional[torch.Tensor] = None) -> None:
        if self.clip_value is not None:
            clip_by_global_norm_([p.grad for p in self.params()],
                                 self.clip_value, norm)
        for group in self.base.param_groups:
            group["lr"] = lr
        self.base.step()
        self.updates += 1

    def update(self, schedule: Callable[[int], float],
               norm: Optional[torch.Tensor] = None,
               reduce: Optional[Callable[[List[torch.Tensor]], None]] = None
               ) -> bool:
        """One micro-batch: ``step(schedule(updates), norm)`` when it
        completes an update (every call when ``accum_steps`` is 1; then
        ``norm``, the gradient's global norm, saves recomputing it).
        With ``accum_steps`` > 1, ``reduce`` (a data-parallel all-reduce)
        takes the completed mean in place before the step. Returns
        whether the parameters were updated."""
        if self.accum_steps > 1:
            params = self.params()
            if self._mean is None:
                self._mean = [torch.zeros_like(p) for p in params]
            # divided by a tensor, not a Python float: on the card the
            # latter is a reciprocal multiply, one bit off the division
            n1 = torch.tensor(float(self._micro + 1),
                              device=self._mean[0].device)
            for m, p in zip(self._mean, params):
                m.add_((p.grad - m) / n1)
            self._micro += 1
            if self._micro < self.accum_steps:
                return False
            for m, p in zip(self._mean, params):
                p.grad = m
            if reduce is not None:
                reduce(self._mean)
            self._mean, self._micro, norm = None, 0, None
        self.step(schedule(self.updates), norm)
        return True

    def zero_grad(self) -> None:
        self.base.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict[str, object]:
        """The torch optimizer's state, ``updates``, and MultiSteps' running
        mean and its micro-batch count."""
        return {"base": self.base.state_dict(), "updates": self.updates,
                "mean": self._mean, "micro": self._micro}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.base.load_state_dict(state["base"])
        self.updates = int(state["updates"])
        mean = state["mean"]
        if mean is not None:
            mean = [m.to(p.device, p.dtype)
                    for m, p in zip(mean, self.params())]
        self._mean, self._micro = mean, int(state["micro"])


def build_optimizer(opt: OptimizationConfig,
                    params: Iterable[nn.Parameter]) -> Optimizer:
    """adam, adamw (decaying every parameter, as ``optax.adamw`` with no
    mask) or sgd with Nesterov momentum, optional global-norm clipping,
    and ``grad_accum_steps`` micro-batches averaged per update. The
    learning rate is given to each :meth:`Optimizer.step` by the
    schedule."""
    params = list(params)
    betas = tuple(opt.adam_betas)
    if opt.optimizer == "adam":
        base = torch.optim.Adam(params, lr=0.0, betas=betas, eps=opt.adam_eps)
    elif opt.optimizer == "adamw":
        base = torch.optim.AdamW(params, lr=0.0, betas=betas,
                                 eps=opt.adam_eps,
                                 weight_decay=opt.weight_decay)
    elif opt.optimizer == "sgd":
        base = torch.optim.SGD(params, lr=0.0, momentum=opt.sgd_momentum,
                               nesterov=opt.sgd_nesterov)
    else:
        raise ValueError(f"Unknown optimizer: {opt.optimizer}")
    return Optimizer(base, opt.gradient_clip_value if opt.gradient_clip
                     else None, max(1, opt.grad_accum_steps))


# -- steps -------------------------------------------------------------------

def _seed(total: torch.Tensor, dp: Optional[DataParallel]):
    """The gradient a rank starts its backward from: 1, or 1/W under a
    group, where every rank holds the same global loss and the parameter
    gradients are then summed over the W ranks."""
    if dp is None:
        return None
    return torch.full_like(total, 1.0 / dp.world_size)


class TrainStep:
    """One micro-batch per call: forward in training mode (batch
    statistics, running statistics moved), the combined loss over
    ``gt > loss.min_depth``, backward, the pre-clip gradient norm, max
    and min of this micro-batch's gradient, then
    :meth:`Optimizer.update`: clipping, the learning rate
    ``schedule(optimizer.updates)`` and the update, on every call or,
    with ``grad_accum_steps`` k, on the mean of every k calls' gradients.
    ``updates`` counts the calls, as the JAX state's ``step``.

    While a profiler records, a call is span ``train.step`` (trace id
    ``updates`` on entry) with children ``train.forward``,
    ``train.loss``, ``train.backward`` (with the zero gradients of unused
    parameters) and ``train.update`` (the gradient's statistics, clipping
    and the optimizer), each with the card's time on a card; a
    data-parallel all-reduce of the gradients lies in the step, outside
    the four, as span ``train.allreduce``.

    Under ``loss_fn.dp`` the logs are the global batch's: the losses, and
    with k = 1 the gradient's norm, max and min (with k > 1 the gradient
    is all-reduced once per update, so those three are this rank's part
    of the micro-batch's gradient)."""

    def __init__(self, cfg: Config, model: nn.Module,
                 loss_fn: CombinedDepthLoss, optimizer: Optimizer,
                 schedule: Callable[[int], float]):
        self.cfg = cfg
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.schedule = schedule
        self.dp = loss_fn.dp
        self.updates = 0

    def __call__(self, batch: Batch) -> Dict[str, torch.Tensor]:
        gt = batch["depth"]
        device = gt.device
        with span("train.step", device=device, trace=self.updates):
            self.model.train()
            valid = gt > self.cfg.loss.min_depth
            self.optimizer.zero_grad()
            with span("train.forward", device=device):
                pred = self.model(*_inputs(self.cfg, batch, self.model.space))
            with span("train.loss", device=device):
                total, comps = self.loss_fn(pred, gt, batch["rgb"],
                                            batch["intrinsics"], valid)
            params = self.optimizer.params()
            with span("train.backward", device=device):
                total.backward(_seed(total, self.dp))
                # JAX gives an unused parameter a zero gradient
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            reduce = None
            if self.dp is not None:
                if self.optimizer.accum_steps == 1:
                    with span("train.allreduce", device=device):
                        self.dp.all_reduce_(grads)
                else:
                    reduce = self.dp.all_reduce_
            with span("train.update", device=device):
                logs = {k: v.detach() for k, v in comps.items()}
                logs["grad_norm"] = global_norm(grads)
                logs["grad_max"] = torch.stack(
                    torch._foreach_max(grads)).max()
                logs["grad_min"] = torch.stack(
                    [g.min() for g in grads]).min()
                self.optimizer.update(self.schedule, logs["grad_norm"],
                                      reduce)
            self.updates += 1
        return logs

    def state_dict(self) -> Dict[str, object]:
        """What a checkpoint keeps: ``step`` (the micro-steps taken, the
        JAX state's ``step``), the model's ``state_dict`` and the
        optimizer's."""
        return {"step": self.updates, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.updates = int(state["step"])


def make_train_step(cfg: Config, model: nn.Module, loss_fn: CombinedDepthLoss,
                    optimizer: Optimizer,
                    schedule: Callable[[int], float]) -> TrainStep:
    """The training step: ``step(batch) -> logs`` with total_loss,
    si_loss, grad_loss, smooth_loss, reproj_loss, the pre-clip grad_norm,
    grad_max and grad_min."""
    return TrainStep(cfg, model, loss_fn, optimizer, schedule)


def make_grad_fn(cfg: Config, model: nn.Module, loss_fn: CombinedDepthLoss
                 ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Gradient-only pass for observability: ``grad_fn(batch)`` returns
    {parameter name: gradient} of the training loss (of the global batch
    under ``loss_fn.dp``, where every rank calls it). As in JAX, the
    running statistics and the parameters' ``.grad`` stay as they were."""
    dp = loss_fn.dp

    def grad_fn(batch: Batch) -> Dict[str, torch.Tensor]:
        model.train()
        names, params = zip(*model.named_parameters())
        saved = {k: v.clone() for k, v in model.named_buffers()}
        gt = batch["depth"]
        pred = model(*_inputs(cfg, batch, model.space))
        total, _ = loss_fn(pred, gt, batch["rgb"], batch["intrinsics"],
                           gt > cfg.loss.min_depth)
        grads = torch.autograd.grad(total, params, _seed(total, dp),
                                    allow_unused=True, materialize_grads=True)
        if dp is not None:
            dp.all_reduce_(list(grads))
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(saved[k])
        return dict(zip(names, grads))

    return grad_fn


def make_eval_step(cfg: Config, model: nn.Module, loss_fn: CombinedDepthLoss
                   ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Validation step: the loss components, the 12 depth metrics over
    (validation.min_depth, validation.max_depth) and ``pcl_max_rot``, the
    largest |predicted rotation| of any PCL (the two-pass warp is
    sub-pixel only below a rotation bound); under ``loss_fn.dp``, of the
    global batch on every rank."""
    dp = loss_fn.dp

    @torch.inference_mode()
    def eval_fn(batch: Batch) -> Dict[str, torch.Tensor]:
        model.eval()
        record: Dict[str, List[torch.Tensor]] = {}
        pred = model(*_inputs(cfg, batch, model.space), record)
        gt = batch["depth"]
        _, comps = loss_fn(pred, gt, batch["rgb"], batch["intrinsics"],
                           gt > cfg.loss.min_depth)
        out = dict(comps)
        out.update(compute_depth_metrics(
            pred, gt, min_depth=cfg.validation.min_depth,
            max_depth=cfg.validation.max_depth, dp=dp))
        if record.get("pcl_max_rot"):
            rot = torch.stack(record["pcl_max_rot"]).max()
            out["pcl_max_rot"] = rot if dp is None else dp.max(rot)
        return out

    return eval_fn


def make_predict_fn(cfg: Config, model: nn.Module
                    ) -> Callable[[Batch], torch.Tensor]:
    """Inference-only forward of ``model`` (put in eval mode) over a
    batch dict with 'rgb', 'intrinsics' and 'k4'; returns depth
    (B, H, W, 1) in metres."""
    model.eval()

    @torch.inference_mode()
    def predict(batch: Batch) -> torch.Tensor:
        # a trainer's steps put the model in training mode between calls
        model.eval()
        return model(*_inputs(cfg, batch, model.space))

    return predict
