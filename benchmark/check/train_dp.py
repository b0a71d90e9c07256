"""What decides ``correct`` in a data-parallel training cell: the training
check's three steps and numbers (``train.py``) over W ranks, against a
float32 reference of the global batch worked out over the same W shards.

The port's side is ``train.py``'s on every rank: the ``Trainer``'s own
step and feed, three steps from the seeded weights; its losses, first
gradient and change are the global batch's on every rank (the state is
replicated), its first depths a rank's own rows.

Those three numbers read one rank's gradient left out of the all-reduce
as no more than bf16's rounding: clipping scales every leaf alike, and
Adam's first steps move each weight by about the learning rate whatever
its gradient. So the port's side also keeps, on the host, the first
step's gradient twice: each rank's own as backward leaves it
(``grad_mine``, a hook on each parameter), and the sum the ranks'
all-reduce gives (``grad_vec``: the clipped gradient scaled back by its
``grad_norm`` over the clip value). ``exchange_gap_first``
(``drivers/train_dp.py``) compares ``grad_vec`` with the ranks'
``grad_mine`` summed in float64 through plain ``torch.distributed``: the
norm of the difference over the norm of the sum. The port's exchange is
a float32 sum of the same W tensors, so a sound run reads float32's
rounding whatever bf16 did to each rank's gradient (which moves the
whole gradient tens of percent off the float32 reference's, as much as
one rank left out does). The reference keeps both too, so that its
readings in the control are compared alike.

The reference runs on every rank, in plain PyTorch through plain
``torch.distributed``: each rank takes its shard's rows of every global
batch as the port's resident feed deals them (the split's W x
``store_rows`` rows in W shards, one permutation a shard from
``default_rng([seed, 0])`` in shard order, draws keyed by the global
row), runs the reference network on them with every batch norm's E[x]
and E[x^2] summed over the ranks in float32 (an all-reduce whose
backward all-reduces their gradients), gathers the predictions and the
batch (a gather whose backward sums the gradients and keeps its own
rows) and takes the global batch's loss, back-propagates it divided by
W, and sums the parameters' gradients over the ranks before clipping,
the schedule and AdamW.

The faults: ``half_batch`` on the reference (each rank's loss rows the
first half of its shard's), and ``drop_rank`` on the port (the last
rank's gradient zeroed as backward leaves it, so that the all-reduce
sums the others' alone).
"""

from __future__ import annotations

import types
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from benchmark.check.train import STEPS, ProgramReadings, _norms
from benchmark.check.train import program_steps as program
from benchmark.core.weights import layout, seeded_state
from benchmark.reference import feed, optim
from benchmark.reference.loss import combined_loss
from benchmark.reference.model import Norm, forward
from benchmark.reference.precision import Precision

BN_EPS = 1e-5


class _Sum(torch.autograd.Function):
    """The sum over the ranks; its backward sums the gradients."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out)
        return out


class _Gather(torch.autograd.Function):
    """The ranks' rows, rank order; its backward sums the gradients over
    the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad)
        r = dist.get_rank()
        return grad[r * ctx.rows:(r + 1) * ctx.rows]


def _global_norm(self, x):
    """``reference.model.Norm``'s training forward over the ranks' global
    batch (every rank holds as many rows)."""
    shape = [1, -1] + [1] * (x.dim() - 2)
    dims = [0] + list(range(2, x.dim()))
    stats = _Sum.apply(torch.cat([x.mean(dims), (x * x).mean(dims)]))
    mean, mean_sq = (stats / float(dist.get_world_size())).chunk(2)
    var = (mean_sq - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + BN_EPS) * self.weight
    return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def shard_rows(seed: int, rows: int, ranks: int, rank: int) -> np.ndarray:
    """This rank's global rows of the epoch-0 batches, in order: the
    resident feed's sharded order over ``ranks`` shards of ``rows``."""
    rng = np.random.default_rng([seed, 0])
    perms = [rng.permutation(rows) for _ in range(ranks)]
    return rank * rows + perms[rank]


def _leaves(flat, params):
    return [part.view(p.shape) for part, p in
            zip(flat.split([p.numel() for p in params.values()]),
                params.values())]


def _host(named) -> Dict[str, torch.Tensor]:
    """Copies on the host (a CPU tensor too: the all-reduce and the
    fault change the gradients in place)."""
    return {n: g.detach().to("cpu", torch.float32, copy=True)
            for n, g in named}


def program_steps(trainer, conf: Dict, seed: int, device,
                  drop_rank: bool = False) -> ProgramReadings:
    """``train.py``'s, with the first step's ``grad_mine`` and
    ``grad_vec`` (the module's docstring); ``drop_rank`` plants that
    fault in the three steps."""
    model = trainer.model
    mine, whole = {}, {}
    last = dist.get_rank() == dist.get_world_size() - 1

    def hook(name):
        def keep(p):
            if not whole:
                mine.update(_host([(name, p.grad)]))
            if drop_rank and last:
                p.grad.zero_()
        return keep

    handles = [p.register_post_accumulate_grad_hook(hook(n))
               for n, p in model.named_parameters() if p.requires_grad]
    step = trainer.train_step
    clip = trainer.optimizer.clip_value

    def keep(batch):
        logs = step(batch)
        if not whole:
            norm = float(logs["grad_norm"])
            scale = max(norm, clip) / clip if clip is not None else 1.0
            whole.update(_host((n, p.grad * scale)
                               for n, p in model.named_parameters()))
        return logs

    trainer.train_step = keep
    try:
        out = program(trainer, conf, seed, device)
    finally:
        trainer.train_step = step
        for h in handles:
            h.remove()
    out.grad_mine, out.grad_vec = mine, whole
    return out


def reference_steps(conf: Dict, scenes: Dict[str, torch.Tensor], seed: int,
                    device, precision: str = "float32",
                    half_batch: bool = False) -> ProgramReadings:
    """The reference's three steps over the process group's ranks (every
    rank calls it), ``conf``'s batch a rank's share; ``pred0`` this
    rank's rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ranks, rank = dist.get_world_size(), dist.get_rank()
    c = conf["config"]
    ref = conf["reference"]
    model = layout(c["model"]["init_features"]).to_empty(device=device)
    model.max_depth = float(c["model"].get("max_depth", 10.0))
    model.load_state_dict(seeded_state(model, seed, device))
    model.set_precision(Precision(precision))
    model.remat = True
    model.train()
    for m in model.modules():
        if isinstance(m, Norm):
            m.forward = types.MethodType(_global_norm, m)
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    n = int(conf["store_rows"])
    distinct = scenes["rgb"].shape[0]
    bsz = c["training"]["batch_size"]
    aug = c["data"]["augmentation"]
    quantized = c["data"].get("device_resident_dtype") == "quantized"
    mine = shard_rows(seed, n, ranks, rank)
    draws = torch.from_numpy(feed.epoch_draws(seed, 0, n * ranks,
                                              aug)).to(device)
    adam = optim.AdamW(list(params.values()), {**c["optimization"], **ref})
    lc = c["loss"]
    weights = {"si": lc["si_weight"], "grad": lc["grad_weight"],
               "smooth": lc["smooth_weight"], "reproj": lc["reproj_weight"]}
    out = ProgramReadings()
    for s in range(STEPS):
        rows = torch.from_numpy(mine[s * bsz:(s + 1) * bsz]).to(device)
        if half_batch:
            rows = rows[:bsz // 2]
        batch = feed.batch(scenes, rows % distinct,
                           draws.index_select(0, rows), aug, quantized)
        pred = forward(model, batch)
        if s == 0:
            out.pred0 = pred.detach().cpu().numpy()
        whole = {k: _Gather.apply(v.detach()) for k, v in batch.items()}
        total, _ = combined_loss(_Gather.apply(pred), whole["depth"],
                                 whole["rgb"], whole["intrinsics"],
                                 whole["depth"] > ref["min_depth"], weights,
                                 ref["si_lambda"], ref["grad_num_scales"])
        grads = torch.autograd.grad(total / float(ranks),
                                    list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        flat = torch.cat([g.detach().reshape(-1) for g in grads])
        if s == 0:
            out.grad_mine = _host(zip(params, _leaves(flat, params)))
        dist.all_reduce(flat)
        grads = _leaves(flat, params)
        if s == 0:
            out.grad_vec = _host(zip(params, grads))
        del pred, batch, whole
        out.losses.append(float(total.detach()))
        if c["optimization"].get("gradient_clip", True):
            optim.clip_(grads, float(c["optimization"]["gradient_clip_value"]))
        if s == 0:
            out.grad = _norms(dict(zip(params, grads)))
        lr = optim.learning_rate(c["optimization"], n // bsz,
                                 c["training"]["num_epochs"], s)
        adam.step(grads, lr)
        del grads, flat
    with torch.no_grad():
        out.change = _norms({k: p - start[k] for k, p in params.items()})
    return out
