"""Helpers of the batch-norm tests (``tests/test_torch_batch_norm.py`` on
the CPU, ``tests/test_torch_cuda.py`` on the card), and one rank of their
two-process runs. Imports no JAX.

    python tests/_torch_batch_norm_worker.py RANK WORLD PORT WORKDIR DEVICE

reads ``WORKDIR/setup.pt`` (the global x and dy, the parameters and the
running statistics), joins a Gloo group (with CUDA tensors on the
card), runs ``batch_norm_train`` with the group's ``DataParallel`` over
this rank's rows of x and its backward with this rank's rows of dy, and
writes ``WORKDIR/out_RANK.pt``: y, the gradients and the running
statistics.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def make_map(shape, dtype, seed=0, offset=2.0):
    """An N(offset, 1.5^2) map of ``dtype`` in channels_last memory: the
    offset makes the mean matter, as after a convolution."""
    rng = np.random.default_rng(seed)
    x = rng.normal(offset, 1.5, shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype).contiguous(
        memory_format=torch.channels_last)


def make_params(c, seed=1):
    """(weight, bias, running_mean, running_var), float32 (c,)."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
            torch.from_numpy(rng.normal(0, 0.3, c).astype(np.float32)),
            torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)),
            torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at each element's magnitude."""
    mag = t.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def close(got, want, dtype, what):
    """float32: within 1e-5 of the largest |want| (the closed form and
    autograd's chain, or two summation orders, round differently, each
    step at float32's 6e-8, and the sums run over N terms); bf16: the
    same in float32 before each side's rounding to bf16, so within one
    bf16 ulp of each element, plus that floor for elements near 0."""
    got, want = got.float(), want.float()
    floor = 1e-5 * want.abs().max()
    tol = floor if dtype == torch.float32 else bf16_ulp(want) + floor
    assert ((got - want).abs() <= tol).all(), \
        (what, (got - want).abs().max().item())


def launch(work: Path, ranks: int, device: str):
    """Run this file as ``ranks`` processes on ``device``; [each rank's
    output]."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(ranks), str(port), str(work),
         device], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(ranks)]
    logs = {}
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(timeout=240)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return [torch.load(work / f"out_{r}.pt") for r in range(ranks)]


def ranks_against_one_process(work: Path, device: str, dtype, shape):
    """Two ranks, each with half the batch under ``dp``, against one
    process with the whole batch: (ranks' outputs, one process's)."""
    from cadepth_tpu_torch.ops.batch_norm import batch_norm_train

    x = make_map(shape, dtype)
    dy = make_map(shape, dtype, seed=6, offset=0.0)
    w, b, rm, rv = make_params(shape[1])
    torch.save({"x": x, "dy": dy, "weight": w, "bias": b,
                "running_mean": rm, "running_var": rv, "out_dtype": dtype},
               work / "setup.pt")
    ranks = launch(work, 2, device)
    xo = x.to(device).requires_grad_()
    wo, bo = w.to(device).requires_grad_(), b.to(device).requires_grad_()
    rmo, rvo = rm.to(device), rv.to(device)
    tracked = torch.zeros((), dtype=torch.long, device=device)
    y = batch_norm_train(xo, wo, bo, rmo, rvo, tracked, 1e-5, 0.01, True,
                         None, dtype)
    y.backward(dy.to(device))
    one = {"y": y.detach().cpu(), "dx": xo.grad.cpu(),
           "dweight": wo.grad.cpu(), "dbias": bo.grad.cpu(),
           "running_mean": rmo.cpu(), "running_var": rvo.cpu(),
           "tracked": tracked.cpu()}
    return ranks, one


def check_ranks(ranks, one, dtype):
    """The ranks' maps, stacked, against one process's; their parameter
    gradients (each rank's own) summed against its; every rank's running
    statistics against its: the sums of a rank's half and of the whole
    batch round differently, hence ``close``'s tolerances (the running
    statistics at 2e-6 relative)."""
    for key in ("y", "dx"):
        close(torch.cat([r[key] for r in ranks]), one[key], dtype, key)
    for key in ("dweight", "dbias"):
        close(ranks[0][key] + ranks[1][key], one[key], torch.float32, key)
    for r in ranks:
        for key in ("running_mean", "running_var"):
            torch.testing.assert_close(r[key], one[key], rtol=2e-6,
                                       atol=1e-7)
        assert int(r["tracked"]) == 1


def main() -> None:
    rank, world, port, workdir, device = (int(sys.argv[1]), int(sys.argv[2]),
                                          sys.argv[3], Path(sys.argv[4]),
                                          torch.device(sys.argv[5]))
    from cadepth_tpu_torch.ops.batch_norm import batch_norm_train
    from cadepth_tpu_torch.parallel import initialize_distributed, make_mesh

    assert initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                                  num_processes=world, process_id=rank,
                                  backend="gloo")
    dp = make_mesh(world)
    setup = torch.load(workdir / "setup.pt", weights_only=False)
    rows = setup["x"].shape[0] // world
    part = slice(rank * rows, (rank + 1) * rows)

    def local(t):
        return t[part].to(device).contiguous(memory_format=torch.channels_last)

    x = local(setup["x"]).requires_grad_()
    w = setup["weight"].to(device).requires_grad_()
    b = setup["bias"].to(device).requires_grad_()
    rm, rv = setup["running_mean"].to(device), setup["running_var"].to(device)
    tracked = torch.zeros((), dtype=torch.long, device=device)
    y = batch_norm_train(x, w, b, rm, rv, tracked, 1e-5, 0.01, True, dp,
                         setup["out_dtype"])
    y.backward(local(setup["dy"]))
    torch.save({k: v.detach().cpu() for k, v in (
        ("y", y), ("dx", x.grad), ("dweight", w.grad), ("dbias", b.grad),
        ("running_mean", rm), ("running_var", rv), ("tracked", tracked))},
        workdir / f"out_{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
