"""What decides ``correct`` in a Depth Anything V2 training cell: the
training check's three steps and numbers (``train.py``: its
``ProgramReadings`` and ``compare``), with the reference network of
``benchmark/reference/dav2.py`` and the weights of
``core/weights_dav2.py``.

Set-up drives the port's ``Trainer`` from the seeded weights through
three steps on the feed's first three batches and keeps each loss, the
first gradient as AdamW got it and the parameters' change. After the
window the reference (plain PyTorch, float32, TF32 off, attention
materialised, each block and each block of query rows recomputed in the
backward) works out the same three steps from the seeded scenes and
weights: the feed's batches, forward, loss, gradient, clipping, the
schedule and AdamW. The leaves of ``refinenet4.resConfUnit1`` get no
gradient on either side; their change is AdamW's decay.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.check.train import STEPS, ProgramReadings, _norms
from benchmark.check.train import compare  # noqa: F401  (the driver's)
from benchmark.core.weights_dav2 import layout, seeded_state
from benchmark.reference import feed, optim
from benchmark.reference.dav2 import Precision, forward
from benchmark.reference.loss import combined_loss


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
    start = seeded_state(layout(conf), seed, device)
    with torch.no_grad():
        out.change = _norms({n: p - start[n] for n, p in named.items()})
    del start
    out.pred0 = out.pred0.cpu().numpy()
    out.losses = [float(x) for x in out.losses]
    return out


def reference_model(conf: Dict, seed: int, device, precision: str):
    """The reference at the configuration's widths holding the seeded
    weights, in training mode, recomputing its blocks in the backward."""
    model = layout(conf).to_empty(device=device)
    model.load_state_dict(seeded_state(model, seed, device))
    model.set_precision(Precision(precision))
    model.set_remat(True)
    return model.train()


def reference_steps(conf: Dict, scenes: Dict[str, torch.Tensor], seed: int,
                    device, precision: str = "float32",
                    half_batch: bool = False) -> ProgramReadings:
    """The reference's three steps from the seeded scenes (on ``device``)
    and weights, the store's row r holding scene r modulo their number.
    ``precision`` "float8" is the control; ``half_batch`` plants a fault
    (each step's loss over the first half of its batch)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = conf["config"]
    ref = conf["reference"]
    model = reference_model(conf, seed, device, precision)
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    n = int(conf["store_rows"])
    distinct = scenes["rgb"].shape[0]
    bsz = c["training"]["batch_size"]
    aug = c["data"]["augmentation"]
    quantized = c["data"].get("device_resident_dtype") == "quantized"
    order = feed.epoch_order(seed, 0, n)
    draws = torch.from_numpy(feed.epoch_draws(seed, 0, n, aug)).to(device)
    adam = optim.AdamW(list(params.values()),
                       {**c["optimization"], **ref})
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
