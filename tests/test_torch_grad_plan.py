"""The fused-loss gradient kernel's launch plan, and the cotangents the
op's backward reads in place.

``grad_plan`` cuts a (B, H, W) map for ``csrc/fused_loss.cu:
grad_kernel``: block (tile, strip, b) holds ``threads_per_row`` x
``groups`` threads; thread (x, y) takes the column unit (``quad``
columns) ``strip * threads_per_row + x`` in rows ``tile * rows + y + r *
groups``, r < ``GRAD_ROWS_PER_THREAD``. Held here, with no card: the
plan depends on the shape alone and passes the C entry point's checks;
the kernel's grid, restated in numpy with its guards, reaches every
pixel exactly once, at the flat index whose ``divmod`` gives the same
(sample, row, column), with no thread taking a unit twice in a row (no
second pass); the flagship's training map is one wave of whole-warp
blocks.

The op's backward reads the cotangents of sums 0, 1 and 3 from the
(4,) ``grad`` autograd hands in, through its stride, where the card
gathers nothing. On the CPU it takes the same three entries: the
Function's gradient of ``stats.sum()`` (a stride-0 cotangent) and of a
weighted sum with a non-contiguous cotangent matches ``jax.grad`` of
JAX's ``fused_depth_loss_stats`` in Pallas interpret mode, within
``test_torch_fused_loss.py``'s rtol 1e-4 (atol 1e-7).
"""

from __future__ import annotations

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadepth_tpu.ops.pallas.fused_loss import fused_depth_loss_stats as jax_stats
from cadepth_tpu_torch.ops import fused_loss as fl
import torch_port_common  # noqa: F401  (one torch thread a process)

THREADS = 256
# the statistics plan's shapes (tests/test_torch_loss_plan.py) and a row
# of exactly 256 quads: the flagship's training map, W % 4 == 0 and not,
# widths past one block's threads, a single row
SHAPES = [(4, 240, 320), (2, 24, 40), (1, 21, 30), (3, 17, 21), (2, 9, 1028),
          (1, 1, 7), (2, 5, 4), (3, 200, 1024), (2, 9, 1024)]
SOURCE = (pathlib.Path(fl.__file__).resolve().parent.parent / "csrc"
          / "fused_loss.cu").read_text()
# an H100 SXM's SMs (the hopper-kernels guide's table), for the one-wave
# check only: the plan itself never asks the card
H100_SMS = 132


def _grid(plan: fl.GradPlan, b: int, h: int, w: int):
    """Every (block, thread, r, lane) of the kernel's launch that passes
    its guards, in numpy: (flat index it loads and stores, its sample,
    row and column, and an id of its thread)."""
    q_ = plan.quad
    n_tiles = -(-h // plan.rows)
    bz, tile, strip, ty, tx, r, k = np.meshgrid(
        np.arange(b), np.arange(n_tiles), np.arange(plan.strips),
        np.arange(plan.groups), np.arange(plan.threads_per_row),
        np.arange(fl.GRAD_ROWS_PER_THREAD), np.arange(q_), indexing="ij")
    q = strip * plan.threads_per_row + tx
    v0 = tile * plan.groups * fl.GRAD_ROWS_PER_THREAD + ty
    v = v0 + r * plan.groups
    live = (q < w // q_) & (v0 < h) & (v < h)
    u = q * q_ + k
    flat = (bz * h + v) * w + u
    thread = (((bz * n_tiles + tile) * plan.strips + strip) * plan.groups
              + ty) * plan.threads_per_row + tx
    return (flat[live], bz[live], v[live], u[live], thread[live], q[live])


def _c_accepts(plan: fl.GradPlan, b: int, h: int, w: int) -> bool:
    """cadepth_fused_loss_grad's checks of a plan, restated (an empty map
    returns before them, with no launch)."""
    nq = w // plan.quad
    return b * h * w == 0 or (
        plan.quad == (4 if w % 4 == 0 else 1)
        and plan.threads_per_row >= 1 and plan.groups >= 1
        and plan.threads_per_row * plan.groups <= THREADS
        and plan.rows == plan.groups * fl.GRAD_ROWS_PER_THREAD
        and 1 <= plan.strips <= 65535 and b <= 65535
        and plan.strips * plan.threads_per_row >= nq
        and (plan.strips - 1) * plan.threads_per_row < nq)


def test_the_rows_a_thread_takes_match_the_kernel():
    got = re.search(r"constexpr int kGradRows = (\d+);", SOURCE)
    assert got and int(got.group(1)) == fl.GRAD_ROWS_PER_THREAD


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_covers_every_pixel_once_at_its_divmod(shape):
    b, h, w = shape
    plan = fl.grad_plan(b, h, w)
    assert _c_accepts(plan, b, h, w)
    assert plan.tiles == b * -(-h // plan.rows)
    threads = plan.threads_per_row * plan.groups
    # the fewest row groups that make the block whole warps, if any fits
    aligned = [g for g in range(1, THREADS // plan.threads_per_row + 1)
               if plan.threads_per_row * g % 32 == 0]
    assert plan.groups == (aligned[0] if aligned
                           else THREADS // plan.threads_per_row)
    assert threads % 32 == 0 or not aligned
    flat, bz, v, u, thread, q = _grid(plan, b, h, w)
    n = b * h * w
    assert np.array_equal(np.bincount(flat, minlength=n), np.ones(n, int))
    sample, rem = np.divmod(flat, h * w)
    row, col = np.divmod(rem, w)
    assert np.array_equal(sample, bz) and np.array_equal(row, v) \
        and np.array_equal(col, u)
    # no second pass: one unit a row of a thread, at most
    # GRAD_ROWS_PER_THREAD rows a thread
    rows_of = np.unique(np.stack([thread, v]), axis=1)
    assert np.unique(np.stack([thread, v, q]), axis=1).shape[1] == \
        rows_of.shape[1]
    assert np.bincount(rows_of[0]).max() <= fl.GRAD_ROWS_PER_THREAD


def test_flagship_plan_is_one_wave_of_whole_warps():
    """(4, 240, 320): 80 quads a row, two rows a block (160 threads, five
    whole warps), 480 blocks: one quad a thread, 76,800 threads, all
    resident at once at the kernel's built-for blocks an SM."""
    plan = fl.grad_plan(4, 240, 320)
    assert plan == fl.GradPlan(quad=4, threads_per_row=80, groups=2, rows=2,
                               strips=1, tiles=480)
    blocks = plan.tiles * plan.strips
    threads = blocks * plan.threads_per_row * plan.groups
    assert threads * plan.quad * fl.GRAD_ROWS_PER_THREAD == 4 * 240 * 320
    built_for = re.search(r"__launch_bounds__\(kThreads, (\d+)\)\s*"
                          r"grad_kernel", SOURCE)
    assert built_for, "grad_kernel's __launch_bounds__ not found"
    assert blocks <= H100_SMS * int(built_for.group(1))
    # wide rows: the widest strip a block spans, equal strips
    assert fl.grad_plan(2, 9, 1028)[:5] == (4, 129, 1, 1, 2)
    assert fl.grad_plan(2, 9, 1024)[:5] == (4, 256, 1, 1, 1)


@pytest.mark.parametrize("shape", [(0, 5, 8), (2, 0, 8), (2, 3, 0)])
def test_empty_maps_plan_and_launch_nothing(shape):
    """An empty map's plan launches no thread, and the op gives its empty
    gradient (the card test checks that it launches nothing)."""
    plan = fl.grad_plan(*shape)
    assert _c_accepts(plan, *shape)
    assert _grid(plan, *shape)[0].size == 0
    pred = torch.ones(shape)
    fl.bwd_launches = 0
    dp = fl.depth_loss_grad(pred, pred, torch.ones(shape[0], 4),
                            torch.ones(3))
    assert dp.shape == shape and fl.bwd_launches == 0


def test_plan_needs_no_card(monkeypatch):
    want = [fl.grad_plan(*s) for s in SHAPES]

    def no_card(*args, **kwargs):
        raise AssertionError("the plan asked the card")

    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert [fl.grad_plan(*s) for s in SHAPES] == want


def _data(rng, b=2, h=24, w=40):
    pred = rng.uniform(0.2, 9.0, size=(b, h, w)).astype(np.float32)
    gt = rng.uniform(0.2, 9.0, size=(b, h, w)).astype(np.float32)
    gt[gt < 1.0] = 0.0
    pred[0, 0, :3] = [0.0, 1e-7, 2000.0]  # outside the clip range
    k4 = np.stack([rng.uniform(0.5, 1.5, b) * w, rng.uniform(0.5, 1.5, b) * w,
                   rng.uniform(0.3, 0.7, b) * w, rng.uniform(0.3, 0.7, b) * h],
                  -1).astype(np.float32)
    return pred, gt, k4


def _cotangents():
    """(name, numpy weights, the torch cotangent autograd hands in):
    stats.sum()'s stride-0 ones, and weights as a [::2] view and as a
    column of a stack (stride 2)."""
    w = np.array([0.3, -1.7, 5.0, 0.01], np.float32)
    wt = torch.from_numpy(w)
    spaced = torch.zeros(8)
    spaced[::2] = wt
    return [("sum", np.ones(4, np.float32), None),
            ("strided", w, spaced[::2]),
            ("stack_column", w, torch.stack([wt, -wt], 1)[:, 0])]


@pytest.mark.parametrize("name,weights,cot", _cotangents(),
                         ids=[c[0] for c in _cotangents()])
def test_function_gradient_matches_jax_for_any_cotangent(name, weights, cot):
    pred, gt, k4 = _data(np.random.default_rng(5))

    def loss_j(x):
        return jnp.dot(jnp.asarray(weights),
                       jax_stats(x, jnp.asarray(gt), jnp.asarray(k4), True))

    want = np.asarray(jax.grad(loss_j)(jnp.asarray(pred)))
    x = torch.from_numpy(pred).requires_grad_(True)
    stats = fl.fused_depth_loss_stats(x, *map(torch.from_numpy, (gt, k4)))
    fl.bwd_launches = 0
    if cot is None:
        stats.sum().backward()
        got = x.grad
    else:
        assert not cot.is_contiguous() and cot.stride(0) == 2
        (got,) = torch.autograd.grad(stats, x, cot)
    assert fl.bwd_launches == 0  # the plain version on the CPU
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-7)
    # the same three entries as the public op's (3,) coefficients
    c = torch.from_numpy(weights)[[0, 1, 3]]
    assert torch.equal(got, fl.depth_loss_grad_plain(
        x.detach(), *map(torch.from_numpy, (gt, k4)), c))


def test_bad_cotangents_and_coefficients_raise():
    pred, gt, k4 = (torch.from_numpy(a) for a in
                    _data(np.random.default_rng(6), 1, 4, 8))
    with pytest.raises(ValueError, match="coefs must be"):
        fl.depth_loss_grad(pred, gt, k4, torch.ones(4))
    with pytest.raises(ValueError, match="1-D"):
        fl._grad(pred, gt, k4, torch.ones(2, 2), (0, 1, 3))
    with pytest.raises(ValueError, match="1-D"):
        fl._grad(pred, gt, k4, torch.ones(3), (0, 1, 3))
    with pytest.raises(ValueError, match="pred's device"):
        fl._grad(pred, gt, k4, torch.ones(4, device="meta"), (0, 1, 3))
