"""The banded affine warp kernel's launch plan and its tap table.

``affine_plan`` cuts a (B, H, W, C) map for ``csrc/banded_affine_warp.cu:
banded_affine_kernel``: a block owns ``rows`` output rows of one sample,
a strip of ``cols`` columns and ``c_chunk`` channels, and first writes a
tap table with one entry for each (row, column) of its tile, then
sweeps (row, column, channel vector). Held here, with no card: the plan
depends on the shape alone, its blocks cover every (row, column,
channel) exactly once, each block's table stays within the shared memory
it plans (at most 48 KB, under the card's 227 KB), the flagship's five
decoder levels get the block counts the design intends, and the sweep's
carried indices (the kernel adds the block's thread count to each
thread's item and carries into the column and the row, dividing only
once) equal the divisions they replace.

The tap table is restated in torch, operation for operation as the
kernel writes it (the four tap weights, zero where a tap lies outside
the band or the image, and the first tap's row and column), and the sum
of its non-zero taps in the kernel's order is held to
``banded_affine_warp_plain`` bit for bit, f32 and bf16, in band and out
of band.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from cadepth_tpu_torch.ops import banded_affine_warp as baw
from cadepth_tpu_torch.ops import two_pass_warp as tpw
import torch_port_common  # noqa: F401  (one torch thread a process)

SMEM_LIMIT = 232448  # the most shared memory a block may use on an H100
# the flagship's five decoder maps (f=64, 240x320): (H, W, C)
LEVELS = {"dec5": (14, 20, 1024), "dec4": (30, 40, 512),
          "dec3": (60, 80, 256), "dec2": (120, 160, 128),
          "dec1": (240, 320, 64)}
# (rows, c_chunk, blocks) at the serving batch (8) and the training batch
# (4): every level has 2,560 16-byte vectors a row in bf16 (5,120 in
# f32); the small levels split their channels until 256 blocks or two
# items a thread
PLANS = {
    (8, torch.bfloat16): {"dec5": (1, 256, 448), "dec4": (1, 256, 480),
                          "dec3": (1, 256, 480), "dec2": (1, 128, 960),
                          "dec1": (1, 64, 1920)},
    (4, torch.bfloat16): {"dec5": (1, 256, 224), "dec4": (1, 128, 480),
                          "dec3": (1, 128, 480), "dec2": (1, 128, 480),
                          "dec1": (1, 64, 960)},
    (8, torch.float32): {"dec5": (1, 256, 448), "dec4": (1, 256, 480),
                         "dec3": (1, 256, 480), "dec2": (1, 128, 960),
                         "dec1": (1, 64, 1920)},
    (4, torch.float32): {"dec5": (1, 128, 448), "dec4": (1, 128, 480),
                         "dec3": (1, 128, 480), "dec2": (1, 128, 480),
                         "dec1": (1, 64, 960)},
}
# odd maps; (8, 240, 32, 8) has so few items a row that blocks take 4 rows
ODD = [(2, 24, 32, 8), (3, 15, 20, 16), (1, 7, 9, 3), (2, 33, 47, 5),
       (2, 5, 6, 12), (1, 3, 3000, 8), (2, 17, 2100, 4), (8, 240, 32, 8)]


def _blocks(plan: baw.AffinePlan, b: int, h: int, w: int, c: int):
    """Each block's (sample, rows, columns, channels), in the kernel's
    block order: the strip fastest, then the tile of rows, the sample
    and the channel chunk."""
    n_strips, n_tiles = -(-w // plan.cols), -(-h // plan.rows)
    for blk in range(plan.blocks):
        strip, rest = blk % n_strips, blk // n_strips
        tile, rest = rest % n_tiles, rest // n_tiles
        s, chunk = rest % b, rest // b
        j0, o0, c0 = tile * plan.rows, strip * plan.cols, chunk * plan.c_chunk
        yield (s, slice(j0, min(j0 + plan.rows, h)),
               slice(o0, min(o0 + plan.cols, w)),
               slice(c0, min(c0 + plan.c_chunk, c)))


def _check_cover(plan, b, h, w, c):
    hits = np.zeros((b, h, w, c), np.uint8)
    for s, rows, cols, chans in _blocks(plan, b, h, w, c):
        assert chans.start < c and (chans.stop - chans.start) % plan.vec == 0
        hits[s, rows, cols, chans] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("batch,dtype", sorted(PLANS, key=str))
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_plan_at_the_decoder_levels(level, batch, dtype):
    h, w, c = LEVELS[level]
    plan = baw.affine_plan(batch, h, w, c, dtype)
    size = 4 if dtype == torch.float32 else 2
    assert (plan.rows, plan.c_chunk, plan.blocks) == PLANS[batch, dtype][level]
    assert plan.vec == 16 // size and plan.cols == w
    assert plan.smem == plan.rows * w * baw.TAP_BYTES <= baw.TABLE_BYTES
    # split only while the launch is short of blocks, and never past two
    # items a thread; rows grow only while the launch keeps its blocks
    items = plan.rows * w * plan.c_chunk // plan.vec
    assert plan.c_chunk == c or baw.plan_of(
        batch, h, w, c, plan.vec, 1, w, 2 * plan.c_chunk).blocks < \
        baw.MIN_BLOCKS
    assert items >= 2 * baw.THREADS and items <= max(baw.MAX_ITEMS,
                                                     w * plan.c_chunk // plan.vec)
    _check_cover(plan, batch, h, w, c)


@pytest.mark.parametrize("shape", ODD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_covers_odd_maps_once(shape, dtype):
    """Channel counts that fill no 16-byte vector (one channel a thread),
    ragged chunks, and rows too wide for one table (strips)."""
    b, h, w, c = shape
    plan = baw.affine_plan(b, h, w, c, dtype)
    assert plan.vec == tpw.vector_width(c, dtype)
    assert plan.c_chunk % plan.vec == 0 and plan.cols <= w
    assert plan.cols == min(w, baw.TABLE_BYTES // baw.TAP_BYTES)
    assert plan.smem <= baw.TABLE_BYTES <= SMEM_LIMIT
    assert plan.blocks == b * -(-h // plan.rows) * -(-w // plan.cols) * \
        -(-c // plan.c_chunk)
    _check_cover(plan, b, h, w, c)
    if shape == (8, 240, 32, 8):
        assert (plan.rows, plan.blocks) == (4, 480)


def test_unaligned_buffers_take_one_channel_a_thread():
    assert baw.affine_plan(8, 240, 320, 64, torch.bfloat16,
                           aligned=False).vec == 1
    assert baw.affine_plan(8, 240, 320, 64, torch.float32,
                           aligned=False).vec == 1


def test_plan_needs_no_card(monkeypatch):
    want = {lv: baw.affine_plan(4, *LEVELS[lv], torch.bfloat16)
            for lv in LEVELS}

    def no_card(*args, **kwargs):
        raise AssertionError("the plan asked the card")

    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert {lv: baw.affine_plan(4, *LEVELS[lv], torch.bfloat16)
            for lv in LEVELS} == want


@pytest.mark.parametrize("nc,cvn", [(320, 8), (20, 32), (9, 3), (5, 1),
                                    (40, 64), (17, 300), (2100, 2)])
def test_carried_indices_equal_the_divisions(nc, cvn):
    """The sweep's index walk of csrc/banded_affine_warp.cu, restated:
    each thread starts at item t and steps by the block's 256 threads,
    carrying cv into the tap index e and oc into the row r."""
    step, rows = baw.THREADS, 3
    items = rows * nc * cvn
    d_e, d_cv = divmod(step, cvn)
    d_r, d_oc = divmod(d_e, nc)
    for t in range(step):
        e, cv = divmod(t, cvn)
        r, oc = divmod(e, nc)
        for item in range(t, items, step):
            assert (e, cv) == divmod(item, cvn)
            assert (r, oc) == divmod(e, nc)
            cv += d_cv
            carry = 1 if cv >= cvn else 0
            cv -= carry * cvn
            e += d_e + carry
            oc += d_oc + carry
            r += d_r
            if oc >= nc:
                oc -= nc
                r += 1


def _tap_table(theta: torch.Tensor, h: int, w: int):
    """The kernel's table for every (sample, row, column): the weights of
    the taps (y, x0), (y, x0 + 1), (y + 1, x0), (y + 1, x0 + 1), (B, H, W,
    4) f32, and y, x0 (B, H, W) int64, with the kernel's f32 operations."""
    ax, bx, cx, ay, by, cy = (t[:, None, None]
                              for t in baw.pixel_coeffs(theta, h, w))
    jf = torch.arange(h, dtype=torch.float32)[None, :, None]
    of = torch.arange(w, dtype=torch.float32)[None, None, :]
    bxj, byj = bx * jf, by * jf
    v0 = (ay * 0.0 + byj) + cy
    v1 = (ay * float(w - 1) + byj) + cy
    ys = torch.floor(torch.minimum(v0, v1)).clamp(-baw.BAND_S, h).long()
    top = torch.ceil(torch.maximum(v0, v1)).clamp(-2.0 ** 24, 2.0 ** 24).long()
    s_hi = (top - ys + 2).clamp_max(baw.BAND_S)
    u = (ax * of + bxj) + cx
    v = (ay * of + byj) + cy
    x0 = torch.floor(u)
    x1 = x0 + 1.0
    wx1 = u - x0
    wx0 = 1.0 - wx1
    in0 = (x0 >= 0) & (x0 <= w - 1)
    in1 = (x1 >= 0) & (x1 <= w - 1)
    fy = torch.floor(v)
    row_ok = (fy >= -1.0) & (fy <= h - 1)
    yi = torch.where(row_ok, fy, torch.zeros_like(fy)).long()
    weights = []
    for dy in (0, 1):
        y = yi + dy
        s = y - ys
        ok = row_ok & (y >= 0) & (y < h) & (s >= 0) & (s < s_hi)
        wy = torch.clamp_min(1.0 - (v - y.float()).abs(), 0.0)
        zero = torch.zeros_like(wy)
        weights += [torch.where(ok & in0, wx0 * wy, zero),
                    torch.where(ok & in1, wx1 * wy, zero)]
    xi = torch.where(in0 | in1, x0, torch.zeros_like(x0)).long()
    return torch.stack(weights, -1), yi, xi


def _from_table(img: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """The kernel's sweep: the taps of non-zero weight added in order."""
    b, h, w, _ = img.shape
    wts, yi, xi = _tap_table(theta, h, w)
    bi = torch.arange(b)[:, None, None]
    acc = torch.zeros(img.shape, dtype=torch.float32)
    for t, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        wt = wts[..., t]
        val = img[bi, (yi + dy).clamp(0, h - 1), (xi + dx).clamp(0, w - 1)]
        acc = torch.where((wt != 0)[..., None],
                          acc + val.float() * wt[..., None], acc)
    return acc.to(img.dtype)


def _rot(rad):
    return [[math.cos(rad), -math.sin(rad), 0.0],
            [math.sin(rad), math.cos(rad), 0.0]]


THETAS = {
    "identity": [[1, 0, 0], [0, 1, 0.0]],
    "zoom_shift": [[1.3, 0, 0.2], [0, 0.7, -0.3]],
    "rotation": [[0.999, -0.037, 0], [0.037, 0.999, 0.0]],
    "oob_translate": [[1, 0, 0.9], [0, 1, 0.9]],
    "zoom_out": [[2.5, 0.1, 0.0], [-0.1, 2.5, 0.0]],
    "rot_0.35": _rot(0.35),
    "rot_0.6": _rot(0.6),
}


@pytest.mark.parametrize("shape", [(2, 24, 32, 8), (1, 48, 64, 4),
                                   (2, 14, 20, 16), (1, 7, 9, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_table_sum_equals_plain(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    img = torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
        .to(dtype)
    for name, th in THETAS.items():
        theta = torch.from_numpy(np.tile(np.asarray(th, np.float32)[None],
                                         (shape[0], 1, 1)))
        if name == "rotation":
            theta = theta + torch.from_numpy(
                rng.normal(scale=0.01, size=theta.shape).astype(np.float32))
        got = _from_table(img, theta)
        want = baw.banded_affine_warp_plain(img, theta)
        assert torch.equal(got, want), (shape, dtype, name)
