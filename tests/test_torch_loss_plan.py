"""The fused-loss statistics kernel's launch plan and its fixed order.

``stats_plan`` cuts a (B, H, W) map for ``csrc/fused_loss.cu:
stats_kernel``: each thread takes ``quad`` neighbouring columns (4 where
W % 4 == 0, else 1), ``threads_per_row`` threads span a row and the
block's 256 threads form ``groups`` row groups; a tile is ``rows`` rows
of one sample, and tile i goes to block i mod ``blocks`` (at most 256
blocks, all resident at once for the cooperative launch). Held here,
with no card: the plan depends on the shape alone, its blocks and
threads cover every pixel exactly once, its shared memory is small, and
the flagship's training map gets the block count the design intends.

The kernel's order of summation is restated in numpy: each thread's f32
sums in its order (its tiles, then columns, then rows, then the quad's
lanes), each block's threads in double through the warp-shuffle tree and
the warps in order, then block 0's sum of the blocks' rows the same way. That
restatement (with numpy's f32 formulas, not the card's ``logf``) is held
against ``depth_loss_stats_plain`` and against JAX's
``fused_depth_loss_stats`` in Pallas interpret mode, the bounds of
``tests/test_torch_cuda.py``: 1e-5 of the sum of each statistic's
terms' magnitudes (sum d can cancel), the count exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadepth_tpu.ops.pallas.fused_loss import fused_depth_loss_stats as jax_stats
from cadepth_tpu_torch.ops import fused_loss as fl
import torch_port_common  # noqa: F401  (one torch thread a process)

THREADS = 256
# the flagship's training map and odd ones: W % 4 == 0 and not, a width
# past one block's threads, a single row
SHAPES = [(4, 240, 320), (2, 24, 40), (1, 21, 30), (3, 17, 21), (2, 9, 1028),
          (1, 1, 7), (2, 5, 4), (3, 200, 1024)]


def _cover(plan: fl.StatsPlan, b: int, h: int, w: int):
    """For each pixel (b, v, u): (block, thread, step) of the kernel's
    loops, in numpy, from the plan alone."""
    q = plan.quad
    tpr, groups, rows = plan.threads_per_row, plan.groups, plan.rows
    n_tiles = -(-h // rows)
    bi, vi, ui = np.meshgrid(np.arange(b), np.arange(h), np.arange(w),
                             indexing="ij")
    quad, lane = ui // q, ui % q
    tile = bi * n_tiles + vi // rows
    v_in = vi % rows
    block = tile % plan.blocks
    thread = (v_in % groups) * tpr + quad % tpr
    rpt = -(-rows // groups)
    per_tile = -(-(w // q) // tpr) * rpt * q
    step = (tile // plan.blocks) * per_tile + \
        ((quad // tpr) * rpt + v_in // groups) * q + lane
    return block, thread, step


@pytest.mark.parametrize("shape", SHAPES)
def test_blocks_and_threads_cover_every_pixel_once(shape):
    b, h, w = shape
    plan = fl.stats_plan(b, h, w)
    assert plan.quad == (4 if w % 4 == 0 else 1)
    assert plan.threads_per_row == min(w // plan.quad, THREADS)
    assert plan.groups == THREADS // plan.threads_per_row >= 1
    assert plan.rows == plan.groups * fl.ROWS_PER_THREAD
    assert plan.tiles == b * -(-h // plan.rows)
    assert plan.blocks == min(plan.tiles, fl.STATS_MAX_BLOCKS)
    block, thread, step = _cover(plan, b, h, w)
    assert block.min() >= 0 and block.max() < plan.blocks
    assert thread.max() < plan.threads_per_row * plan.groups <= THREADS
    # no two pixels share a (block, thread, step) slot
    slots = (block * THREADS + thread) * (step.max() + 1) + step
    assert np.unique(slots).size == slots.size
    # each block's pixels are whole tiles: rows of one sample each
    tiles_of = -(-plan.tiles // plan.blocks)
    for blk in range(plan.blocks):
        at = np.nonzero(block == blk)
        assert np.unique(at[1]).size <= plan.rows * tiles_of
        assert np.unique(at[0] * h + at[1] // plan.rows * plan.rows).size \
            <= tiles_of


def test_flagship_plan_and_small_memory():
    """(4, 240, 320): 80 threads of four columns a row, three row groups
    of two rows each: 160 tiles of six rows, a block each; the shared
    memory holds 4 x 8 doubles; a large map's tiles share the 256
    blocks."""
    plan = fl.stats_plan(4, 240, 320)
    assert plan == fl.StatsPlan(quad=4, threads_per_row=80, groups=3,
                                rows=6, tiles=160, blocks=160)
    # block_sum4's shared rows
    assert 4 * (THREADS // 32) * 8 <= 48 * 1024
    big = fl.stats_plan(3, 200, 1024)
    assert (big.rows, big.tiles, big.blocks) == (2, 300, 256)


@pytest.mark.parametrize("shape,blocks", [((0, 5, 8), 1), ((2, 0, 8), 2),
                                          ((2, 3, 0), 2)])
def test_empty_maps_plan_at_least_one_block(shape, blocks):
    """An empty map still takes a launch (its block 0 writes the zeros):
    one tile a sample where H = 0, one block where B = 0."""
    plan = fl.stats_plan(*shape)
    assert plan.blocks == blocks


def test_plan_needs_no_card(monkeypatch):
    want = [fl.stats_plan(*s) for s in SHAPES]

    def no_card(*args, **kwargs):
        raise AssertionError("the plan asked the card")

    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert [fl.stats_plan(*s) for s in SHAPES] == want


def _tree(v: np.ndarray) -> np.ndarray:
    """block_sum4 of csrc/fused_loss.cu over the last axis (THREADS
    values, f64): __shfl_down_sync's tree in each warp, then the warps'
    sums in order."""
    v = v.reshape(v.shape[:-1] + (THREADS // 32, 32)).copy()
    for off in (16, 8, 4, 2, 1):
        v[..., :32 - off] = v[..., :32 - off] + v[..., off:]
    total = np.zeros(v.shape[:-2], np.float64)
    for warp in range(THREADS // 32):
        total = total + v[..., warp, 0]
    return total


def _kernel_order_stats(pred, gt, k4):
    """The four statistics summed in the kernel's order (numpy's f32
    formulas per pixel)."""
    b, h, w = pred.shape
    plan = fl.stats_plan(b, h, w)
    block, thread, step = _cover(plan, b, h, w)
    p, g = torch.from_numpy(pred), torch.from_numpy(gt)
    xs, ys = fl._geometry(p, torch.from_numpy(k4))
    mask = (g > fl.EPS).numpy()
    d = fl._log_diff(p, g).numpy()
    e = (p - g)
    ex, ey = xs * e, ys * e
    rep = torch.sqrt(((ex * ex + ey * ey) + e * e) + fl.EPS).numpy()
    terms = [d, (d * d).astype(np.float32), np.ones_like(d), rep]
    n_steps = int(step.max()) + 1
    rows = np.zeros((4, plan.blocks), np.float64)
    for m, term in enumerate(terms):
        slots = np.zeros((plan.blocks, THREADS, n_steps), np.float32)
        slots[block[mask], thread[mask], step[mask]] = term[mask]
        s = np.zeros((plan.blocks, THREADS), np.float32)
        for k in range(n_steps):
            s = s + slots[..., k]
        rows[m] = _tree(s.astype(np.float64))
    # block 0: thread t sums rows t, t + THREADS, ... in order
    per_thread = np.zeros((4, THREADS), np.float64)
    for start in range(0, plan.blocks, THREADS):
        chunk = rows[:, start:start + THREADS]
        per_thread[:, :chunk.shape[1]] += chunk
    return _tree(per_thread).astype(np.float32)


def _data(rng, b, h, w, empty=False):
    pred = rng.uniform(0.2, 9.0, size=(b, h, w)).astype(np.float32)
    gt = rng.uniform(0.2, 9.0, size=(b, h, w)).astype(np.float32)
    gt[gt < 1.0] = 0.0
    if empty:
        gt[:] = 0.0
    pred[0, 0, :3] = [0.0, 1e-7, 2000.0][:w]  # outside the clip range
    k4 = np.stack([rng.uniform(0.5, 1.5, b) * w, rng.uniform(0.5, 1.5, b) * w,
                   rng.uniform(0.3, 0.7, b) * w, rng.uniform(0.3, 0.7, b) * h],
                  -1).astype(np.float32)
    return pred, gt, k4


@pytest.mark.parametrize("shape,empty", [((2, 24, 40), False),
                                         ((1, 21, 30), False),
                                         ((3, 17, 21), False),
                                         ((4, 60, 80), False),
                                         ((3, 200, 1024), False),
                                         ((1, 7, 5), True)])
def test_kernel_order_matches_plain_and_jax(shape, empty):
    pred, gt, k4 = _data(np.random.default_rng(sum(shape)), *shape, empty)
    got = _kernel_order_stats(pred, gt, k4)
    plain = fl.depth_loss_stats_plain(*(torch.from_numpy(a)
                                        for a in (pred, gt, k4))).numpy()
    want = np.asarray(jax_stats(jnp.asarray(pred), jnp.asarray(gt),
                                jnp.asarray(k4), interpret=True))
    d = np.where(gt > fl.EPS, np.log(np.clip(pred, fl.EPS, fl.CLAMP_MAX))
                 - np.log(np.clip(gt, fl.EPS, fl.CLAMP_MAX)), 0.0)
    mag = np.maximum([np.abs(d).sum(), plain[1], plain[2], plain[3]], 1.0)
    for ref in (plain, want):
        assert got[2] == ref[2]
        assert (np.abs(got - ref) / mag).max() <= 1e-5, (got, ref)
    if empty:
        assert not got.any()
