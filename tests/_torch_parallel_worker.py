"""One rank of the two-process data-parallel runs of
``tests/test_torch_parallel.py`` (Gloo on the CPU).

    python tests/_torch_parallel_worker.py RANK WORLD PORT WORKDIR

Reads ``WORKDIR/setup.pt`` (written by the test: configs, initial state
dicts and global batches), joins the group through
``initialize_distributed``, runs every case on this rank's rows of each
global batch and writes ``WORKDIR/out_RANK.pt``. Imports no JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)


def schedule_of(cfg, case):
    from cadepth_tpu_torch.training.schedule import build_lr_schedule

    return build_lr_schedule(cfg.optimization, case["steps_per_epoch"],
                             cfg.training.num_epochs)


def steps_case(case, dp):
    """The data-parallel train step over the case's global batches, from
    the case's ``state`` or, where it has one, the train step's state
    ``start``: logs, the train step's state before and BN running
    statistics after each step, parameters after the last; and the
    gradient of ``grad_batch``. With ``dp`` None, one process over the
    whole global batches (the test's reference)."""
    from cadepth_tpu_torch import config as port_config
    from cadepth_tpu_torch.parallel import shard_batch
    from cadepth_tpu_torch.training import train_state as ts

    def rows(batch):
        return batch if dp is None else shard_batch(batch, dp)

    cfg = port_config.config_from_dict(case["raw"])
    model, loss_fn = ts.build_model_and_loss(cfg, device="cpu", dp=dp)
    model.load_state_dict(case["state"])
    optimizer = ts.build_optimizer(cfg.optimization, model.parameters())
    step = ts.make_train_step(cfg, model, loss_fn, optimizer,
                              schedule_of(cfg, case))
    if "start" in case:
        step.load_state_dict(case["start"])
    logs, stats, before = [], [], []
    for batch in case["batches"]:
        before.append(copy.deepcopy(step.state_dict()))
        logs.append({k: float(v) for k, v in step(rows(batch)).items()})
        stats.append({k: v.clone() for k, v in model.named_buffers()
                      if "running" in k})
    out = {}
    if "grad_batch" in case:
        batch = rows(case["grad_batch"])
        out["grads"] = ts.make_grad_fn(cfg, model, loss_fn)(batch)
    if "grad_batch" in case and dp is not None:
        # per-rank losses averaged (batch norms synchronized): the loss of
        # plain DDP, which is not the global batch's
        local = dataclasses.replace(loss_fn, dp=None)
        model.train()
        gt = batch["depth"]
        pred = model(*ts._inputs(cfg, batch))
        args = (gt, batch["rgb"], batch["intrinsics"], gt > cfg.loss.min_depth)
        out["global_loss"] = float(loss_fn(pred.detach(), *args)[0])
        total, _ = local(pred, *args)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(
            total, params, torch.full_like(total, 1.0 / dp.world_size),
            allow_unused=True, materialize_grads=True)
        dp.all_reduce_(list(grads))
        out["naive_grads"] = dict(zip(names, grads))
        out["naive_loss"] = float(dp.mean(total.detach()))
    return {"logs": logs, "stats": stats, "before": before, **out,
            "params": {k: v.detach().clone()
                       for k, v in model.named_parameters()}}


def api_case(case, dp):
    """shard_batch, replicate_state, the batch-size rule and
    initialize_distributed's idempotence."""
    from cadepth_tpu_torch import config as port_config
    from cadepth_tpu_torch.parallel import (initialize_distributed,
                                            replicate_state, shard_batch)
    from cadepth_tpu_torch.training import train_state as ts
    from cadepth_tpu_torch.training import trainer as tm

    out = {"again": initialize_distributed(),
           "shard": shard_batch(case["batch"], dp)}
    cfg = port_config.config_from_dict(case["raw"])
    model, loss_fn = ts.build_model_and_loss(
        cfg, device="cpu", dp=dp,
        generator=torch.Generator().manual_seed(dp.rank))
    optimizer = ts.build_optimizer(cfg.optimization, model.parameters())
    step = ts.make_train_step(cfg, model, loss_fn, optimizer,
                              schedule_of(cfg, case))
    step(shard_batch(case["batch"], dp))     # Adam's moments, per rank
    for p in model.parameters():             # ranks now differ
        p.data.add_(float(dp.rank))
    replicate_state(step, dp)
    out["replicated"] = {
        "model": {k: v.clone() for k, v in model.state_dict().items()},
        "moments": [v.clone() for s in optimizer.base.state.values()
                    for v in s.values()]}
    bad = port_config.config_from_dict(dict(case["raw"],
                                            training={"batch_size": 3}))
    try:
        tm.data_parallel_group(bad, torch.device("cpu"))
    except ValueError as exc:
        out["batch_error"] = str(exc)
    # the data x space rule: spatial_parallel must divide the ranks, and
    # the input height
    out["spatial_errors"] = {}
    for name, extra in (
            ("ranks", {"hardware": {"spatial_parallel": 3}}),
            ("height", {"hardware": {"spatial_parallel": 2},
                        "data": dict(case["raw"]["data"], input_height=33)})):
        try:
            tm.data_parallel_group(port_config.config_from_dict(
                dict(case["raw"], **extra)), torch.device("cpu"))
        except ValueError as exc:
            out["spatial_errors"][name] = str(exc)
    spatial = tm.data_parallel_group(port_config.config_from_dict(
        dict(case["raw"], hardware={"spatial_parallel": 2})),
        torch.device("cpu"))
    out["spatial"] = (spatial.world_size, spatial.data_size,
                      spatial.space.size, spatial.space.rank)
    return out


def trainer_case(case, dp):
    """A Trainer for one epoch, then resumed from rank 0's checkpoint for
    a second; the same with the device feed."""
    from cadepth_tpu_torch import config as port_config
    from cadepth_tpu_torch.training.trainer import Trainer

    out = {}
    for name, raw in case["runs"]:
        tr = Trainer(port_config.config_from_dict(raw), device="cpu")
        try:
            tr.train()
            out[name] = {
                "start_epoch": tr.start_epoch, "history": tr.history,
                "ranks": tr.dp.world_size, "rank": tr.dp.rank,
                "params": {k: v.detach().clone()
                           for k, v in tr.model.named_parameters()}}
        finally:
            tr.close()
    return out


def main() -> None:
    rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], Path(sys.argv[4]))
    from cadepth_tpu_torch.parallel import initialize_distributed, make_mesh

    assert initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                                  num_processes=world, process_id=rank,
                                  backend="gloo")
    dp = make_mesh(world)
    setup = torch.load(workdir / "setup.pt", weights_only=False)
    runners = {"steps": steps_case, "api": api_case,
               "trainer": trainer_case}
    out = {name: runners[case["kind"]](case, dp)
           for name, case in setup.items()}
    torch.save(out, workdir / f"out_{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
