"""What decides ``correct`` in a training cell.

Set-up drives the port's ``Trainer`` from the seeded weights through
three steps on the feed's first three batches (the window's own call and
feed, rows that all differ), and keeps: each step's loss, the first
gradient as the optimizer got it (AdamW's first moment after one step,
divided by 1 - beta1), and the parameters' change over the three steps.
Once the window has closed and the port's state is freed, the reference
(plain PyTorch, float32, TF32 off) works out the same three steps from
the seeded scenes and weights alone: the feed's batches, forward, loss,
gradient, clipping, the schedule and AdamW.

The numbers (those the cell's file gives a limit are compared with it):

- ``depth_dev_first``: the first step's predicted depths (same weights,
  same batch) against the reference's, the frames' mean of their gap as
  a share of the reference's own variation (``depth.py``);
- ``loss_gap``: the largest relative gap of a step's loss;
  ``loss_gap_first``: the first step's, on the same weights;
- ``grad_gap``: over the leaves, the largest gap between the norms of
  the first gradient, as a share of the reference's norm of that leaf or
  of the median leaf, whichever is larger;
- ``update_gap``: the same for the norms of the three steps' change,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (the others, such as a bias ahead of a batch norm,
  move under Adam by round-off alone);
- ``grad_gap_median``, ``update_gap_median``: the median leaf's gap, steady
  from seed to seed where a few small leaves' gradients are sums that
  cancel, so that rounding moves their norms by tens of percent.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.check.depth import deviation
from benchmark.core.weights import layout, seeded_state
from benchmark.reference import feed, optim
from benchmark.reference.loss import combined_loss
from benchmark.reference.model import forward
from benchmark.reference.precision import Precision

STEPS = 3
# leaves whose reference gradient is under this share of the median
# leaf's are left out of update_gap
NOUGHT = 1e-3


def _norms(named) -> Dict[str, float]:
    names = list(named)
    if not names:
        return {}
    vals = torch.stack([torch.linalg.vector_norm(named[n].float())
                        for n in names]).cpu().tolist()
    return dict(zip(names, vals))


class ProgramReadings:
    """The port's side, read during set-up."""

    def __init__(self):
        self.losses: List[torch.Tensor] = []
        self.grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        # the first step's predicted depth (on the host)
        self.pred0 = None


def program_steps(trainer, conf: Dict, seed: int, device) -> ProgramReadings:
    """The first three steps through the trainer's own step and feed."""
    b1 = float(conf["reference"]["adam_betas"][0])
    out = ProgramReadings()
    named = dict(trainer.model.named_parameters())
    hook = trainer.model.register_forward_hook(
        lambda m, args, pred: setattr(out, "pred0", pred.detach().float()))
    it = iter(trainer.train_pipe)
    for s in range(STEPS):
        logs = trainer.train_step(next(it))
        hook.remove()
        out.losses.append(logs["total_loss"].detach().float())
        if s == 0:
            state = trainer.optimizer.base.state
            out.grad = _norms({n: state[p]["exp_avg"] / (1.0 - b1)
                               for n, p in named.items()
                               if p in state and "exp_avg" in state[p]})
    start = seeded_state(layout(conf["config"]["model"]["init_features"]),
                         seed, device)
    with torch.no_grad():
        out.change = _norms({n: p - start[n] for n, p in named.items()})
    del start
    out.pred0 = out.pred0.cpu().numpy()
    out.losses = [float(x) for x in out.losses]
    return out


def reference_steps(conf: Dict, scenes: Dict[str, torch.Tensor], seed: int,
                    device, precision: str = "float32",
                    half_batch: bool = False) -> ProgramReadings:
    """The reference's three steps from the seeded scenes (on
    ``device``) and weights, the store's row r holding scene r modulo
    their number, as the pack's sample list repeats them. ``precision`` "float8" is the control;
    ``half_batch`` plants a fault (each step's mean over the first half
    of its batch)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = conf["config"]
    ref = conf["reference"]
    f = c["model"]["init_features"]
    model = layout(f).to_empty(device=device)
    model.max_depth = float(c["model"].get("max_depth", 10.0))
    model.load_state_dict(seeded_state(model, seed, device))
    model.set_precision(Precision(precision))
    model.remat = True
    model.train()
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    n = int(conf["store_rows"])
    distinct = scenes["rgb"].shape[0]
    bsz = c["training"]["batch_size"]
    aug = c["data"]["augmentation"]
    quantized = c["data"].get("device_resident_dtype") == "quantized"
    order = feed.epoch_order(seed, 0, n)
    draws = torch.from_numpy(feed.epoch_draws(seed, 0, n, aug)).to(device)
    opt_cfg = {**c["optimization"], **ref}
    adam = optim.AdamW(list(params.values()), opt_cfg)
    lc = c["loss"]
    weights = {"si": lc["si_weight"], "grad": lc["grad_weight"],
               "smooth": lc["smooth_weight"], "reproj": lc["reproj_weight"]}
    out = ProgramReadings()
    for s in range(STEPS):
        rows = torch.from_numpy(order[s * bsz:(s + 1) * bsz]).to(device)
        if half_batch:
            rows = rows[:bsz // 2]
        batch = feed.batch(scenes, rows % distinct,
                           draws.index_select(0, rows), aug, quantized)
        pred = forward(model, batch)
        total, _ = combined_loss(pred, batch["depth"], batch["rgb"],
                                 batch["intrinsics"],
                                 batch["depth"] > ref["min_depth"], weights,
                                 ref["si_lambda"], ref["grad_num_scales"])
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        grads = [g.detach() for g in grads]
        if s == 0:
            out.pred0 = pred.detach().cpu().numpy()
        del pred, batch
        out.losses.append(float(total.detach()))
        if c["optimization"].get("gradient_clip", True):
            optim.clip_(grads, float(c["optimization"]["gradient_clip_value"]))
        if s == 0:
            out.grad = _norms(dict(zip(params, grads)))
        lr = optim.learning_rate(c["optimization"], n // bsz,
                                 c["training"]["num_epochs"], s)
        adam.step(grads, lr)
        del grads
    with torch.no_grad():
        out.change = _norms({k: p - start[k] for k, p in params.items()})
    return out


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               leaves) -> List[float]:
    median = float(np.median([ref[k] for k in ref]))
    gaps = []
    for k in leaves:
        gap = abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30)
        gaps.append(gap if math.isfinite(gap) else math.inf)
    return gaps


def compare(prog: ProgramReadings, ref: ProgramReadings) -> Dict[str, float]:
    loss_gap = max((abs(p - r) / abs(r) if math.isfinite(p) else math.inf)
                   for p, r in zip(prog.losses, ref.losses))
    median_grad = float(np.median(list(ref.grad.values())))
    moved = [k for k, g in ref.grad.items() if g >= NOUGHT * median_grad]
    grad = _leaf_gaps(prog.grad, ref.grad, ref.grad)
    change = _leaf_gaps(prog.change, ref.change, moved)
    first = prog.losses[0]
    return {"depth_dev_first": float(np.mean(deviation(prog.pred0,
                                                       ref.pred0))),
            "loss_gap": loss_gap,
            "loss_gap_first": abs(first - ref.losses[0]) / abs(ref.losses[0])
            if math.isfinite(first) else math.inf,
            "grad_gap": max(grad), "grad_gap_median": float(np.median(grad)),
            "update_gap": max(change),
            "update_gap_median": float(np.median(change))}
