"""One rank of the spatial-parallel runs of ``tests/test_torch_spatial.py``
and ``tests/test_torch_spatial_train.py`` (Gloo on the CPU).

    python tests/_torch_spatial_worker.py RANK WORLD PORT WORKDIR

Reads ``WORKDIR/setup.pt`` (written by the test: cases, each naming its
``spatial`` S, with configs, initial state dicts and global tensors),
joins the group through ``initialize_distributed``, makes the data x
space group ``make_mesh_2d(WORLD, S)`` of each case (every rank in the
same order), runs every case on this rank's part and writes
``WORKDIR/out_RANK.pt``. Imports no JAX.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# each rank's own limit: a hung collective fails the test, not the suite
WORKER_TIMEOUT_S = 240


def launch(work: Path, ranks: int):
    """Run this worker on ``ranks`` processes over ``work/setup.pt``;
    {rank: its output}."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(ranks), str(port), str(work)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(ranks)]
    logs = {}
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(timeout=WORKER_TIMEOUT_S)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return {r: torch.load(work / f"out_{r}.pt", weights_only=False)
            for r in range(ranks)}


def _band(x, dp, dim=2):
    """This rank's band of a whole map along ``dim``."""
    return dp.space.band(x, dim)


def ops_case(case, dp):
    """Each collective of the space group and each layer that crosses
    bands, on this rank's band of the case's global tensors: the output
    and the gradients of ``sum(out * cot)``, ``cot`` this rank's
    cotangent of the case."""
    from cadepth_tpu_torch.models.attention import (ChannelAttention,
                                                    DepthSpatialAttention,
                                                    SpatialAttention)
    from cadepth_tpu_torch.models.layers import Conv2d, GroupNorm
    from cadepth_tpu_torch.models.pcl import PerspectiveCorrectionLayer
    from cadepth_tpu_torch.parallel import spatial

    sp = dp.space
    x_whole = case["x"]                    # (B, C, H, W), channels_last

    def run(fn, module=None, cot=None):
        x = _band(x_whole, dp).clone().requires_grad_()
        out = fn(x)
        c = case["cots"][sp.rank][:out.numel()].reshape(out.shape) \
            if cot is None else cot
        (out * c).sum().backward()
        grads = {} if module is None else {
            k: p.grad.clone() for k, p in module.named_parameters()}
        return {"out": out.detach(), "dx": x.grad, "grads": grads}

    out = {}
    for rows in case["halo_rows"]:
        out[f"halo_{rows}"] = run(lambda x, r=rows: sp.halo(x, r, 2))
    out["gather"] = run(lambda x: sp.gather(x, 2))
    out["band"] = run(lambda x: sp.band(sp.gather(x, 2) * 2.0, 2))
    out["sum"] = run(lambda x: sp.sum((x * x).sum(dim=(2, 3))))
    out["amax"] = run(lambda x: sp.amax(x, (2, 3)))
    out["mean_hw"] = run(lambda x: sp.mean_hw(x))

    modules = {
        "conv3x3": Conv2d(case["x"].shape[1], 5, 3, padding=1,
                          dtype=torch.float32),
        "gate7x7": SpatialAttention(7, torch.float32),
        "dilated": DepthSpatialAttention(case["x"].shape[1], 7,
                                         torch.float32),
        "group_norm": GroupNorm(2, case["x"].shape[1], eps=1e-6),
        "channel_gate": ChannelAttention(case["x"].shape[1], 2,
                                         torch.float32),
    }
    for name, m in modules.items():
        m.load_state_dict(case["modules"][name])
        with spatial.banded(sp):
            out[name] = run(m, m)

    pcl = PerspectiveCorrectionLayer(case["x"].shape[1])
    pcl.load_state_dict(case["modules"]["pcl"])
    k4 = case["k4"]
    x = _band(x_whole, dp).clone().requires_grad_()
    with spatial.banded(sp):
        y = pcl(x, k4)
    cot = _band(case["pcl_cot"], dp)
    (y * cot).sum().backward()
    out["pcl"] = {"out": y.detach(), "dx": x.grad,
                  "grads": {k: p.grad.clone()
                            for k, p in pcl.named_parameters()}}
    return out


def forward_case(case, dp):
    """One training-mode forward of the case's model on this rank's part
    of the global batch: its depth band (None dp: one process's forward
    over the whole batch)."""
    from cadepth_tpu_torch import config as port_config
    from cadepth_tpu_torch.parallel import shard_batch
    from cadepth_tpu_torch.training import train_state as ts

    cfg = port_config.config_from_dict(case["raw"])
    model, _ = ts.build_model_and_loss(cfg, device="cpu", dp=dp)
    model.load_state_dict(case["state"])
    model.train()
    batch = case["batch"] if dp is None else shard_batch(case["batch"], dp)
    with torch.no_grad():
        return model(*ts._inputs(cfg, batch, model.space))


def steps_case(case, dp):
    """The gradient of the training loss of the first global batch and
    the eval step on it from the case's state, then the train steps over
    its global batches: the gradient, the eval step's outputs, the logs
    of each step, the parameters after the last (None dp: one process
    over the whole batches, the tests' reference, and the gradients of
    the first batch with its samples reversed and rotated by one, the
    same sums in other orders); with ``grad_batch``, the gradient of the
    training loss of that batch alone."""
    from cadepth_tpu_torch import config as port_config
    from cadepth_tpu_torch.parallel import shard_batch
    from cadepth_tpu_torch.training import train_state as ts
    from cadepth_tpu_torch.training.schedule import build_lr_schedule

    def part(batch):
        return batch if dp is None else shard_batch(batch, dp)

    cfg = port_config.config_from_dict(case["raw"])
    model, loss_fn = ts.build_model_and_loss(cfg, device="cpu", dp=dp)
    model.load_state_dict(case["state"])
    if "grad_batch" in case:
        grads = ts.make_grad_fn(cfg, model, loss_fn)(part(case["grad_batch"]))
        return {"grads": grads}
    optimizer = ts.build_optimizer(cfg.optimization, model.parameters())
    step = ts.make_train_step(
        cfg, model, loss_fn, optimizer,
        build_lr_schedule(cfg.optimization, case["steps_per_epoch"],
                          cfg.training.num_epochs))
    # the gradient and the eval step from the initial state, then the steps
    grad_fn = ts.make_grad_fn(cfg, model, loss_fn)
    first = case["batches"][0]
    grads = grad_fn(part(first))
    reordered = None
    if dp is None:
        n = first["rgb"].shape[0]
        reordered = [grad_fn({k: v[order] for k, v in first.items()})
                     for order in (list(range(n))[::-1],
                                   list(range(1, n)) + [0])]
    evals = {k: float(v) for k, v in ts.make_eval_step(cfg, model, loss_fn)(
        part(case["batches"][0])).items()}
    logs = [{k: float(v) for k, v in step(part(b)).items()}
            for b in case["batches"]]
    return {"logs": logs, "eval": evals, "grads": grads,
            "reordered_grads": reordered,
            "params": {k: v.detach().clone()
                       for k, v in model.named_parameters()}}


def trainer_case(case, dp):
    """A Trainer for one epoch from each of the case's configs."""
    from cadepth_tpu_torch import config as port_config
    from cadepth_tpu_torch.training.trainer import Trainer

    out = {}
    for name, raw in case["runs"]:
        tr = Trainer(port_config.config_from_dict(raw), device="cpu")
        try:
            metrics = tr.train()
            out[name] = {"history": tr.history, "metrics": metrics,
                         "ranks": tr.dp.world_size,
                         "bands": tr.dp.space.size,
                         "params": {k: v.detach().clone()
                                    for k, v in tr.model.named_parameters()}}
        finally:
            tr.close()
    return out


def main() -> None:
    rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], Path(sys.argv[4]))
    from cadepth_tpu_torch.parallel import (initialize_distributed,
                                            make_mesh_2d)

    assert initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                                  num_processes=world, process_id=rank,
                                  backend="gloo")
    setup = torch.load(workdir / "setup.pt", weights_only=False)
    meshes = {}
    runners = {"ops": ops_case, "forward": forward_case,
               "steps": steps_case, "trainer": trainer_case}
    out = {}
    for name, case in setup.items():
        s = case["spatial"]
        if s not in meshes:
            meshes[s] = make_mesh_2d(world, s)
        out[name] = runners[case["kind"]](case, meshes[s])
    torch.save(out, workdir / f"out_{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
