"""The shared-memory plan of the two-pass warp's kernels.

``fwd_plan`` chooses how many channels of a whole row one block of the
forward (and of the transposed pass H) holds in shared memory: all of
them, halved in whole 16-byte vectors until the row's chunk fits
``SMEM_TARGET`` (48 KB), and it refuses a width whose single vector per
pixel exceeds the 227 KB a block may use. Needs no card.
"""

from __future__ import annotations

import pytest
import torch

import torch_port_common  # noqa: F401  (one torch thread per process)
from cadepth_tpu_torch.ops import two_pass_warp as warp_mod

# the flagship's five decoder maps (chip_smoke.py: decoder_shapes at f=64,
# 240x320): every row holds W*C = 20,480 values
LEVELS = {"dec5": (20, 1024), "dec4": (40, 512), "dec3": (80, 256),
          "dec2": (160, 128), "dec1": (320, 64)}
# chunk at every level: all C in bf16 (40 KB), C/2 in f32 (40 KB)
SPLIT = {torch.bfloat16: 1, torch.float32: 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_plan_at_the_decoder_levels(level, dtype):
    w, c = LEVELS[level]
    size = 4 if dtype == torch.float32 else 2
    assert warp_mod.vector_width(c, dtype) == 16 // size
    chunk, smem = warp_mod.fwd_plan(w, c, dtype)
    assert chunk == c // SPLIT[dtype] and smem == w * chunk * size == 40960
    assert smem <= warp_mod.SMEM_TARGET and chunk % (16 // size) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_at_an_odd_channel_count(dtype):
    """C = 3 (or a misaligned buffer): one channel per thread (VEC = 1),
    and chunks of any whole number of channels."""
    size = 4 if dtype == torch.float32 else 2
    assert warp_mod.vector_width(3, dtype) == 1
    assert warp_mod.vector_width(64, dtype, aligned=False) == 1
    assert warp_mod.fwd_plan(9, 3, dtype) == (3, 9 * 3 * size)
    # 8001 * 3 * 4 = 96,012 bytes in f32: one channel a block
    chunk, smem = warp_mod.fwd_plan(8001, 3, dtype)
    assert chunk == (3 if dtype == torch.bfloat16 else 1)
    assert smem == 8001 * chunk * size <= warp_mod.SMEM_TARGET
    chunk, smem = warp_mod.fwd_plan(320, 64, dtype, aligned=False)
    assert chunk == (64 if dtype == torch.bfloat16 else 32)
    assert smem == 320 * chunk * size <= warp_mod.SMEM_TARGET


def test_plan_keeps_small_rows_whole_and_ragged_chunks_vectors():
    assert warp_mod.fwd_plan(32, 8, torch.float32) == (8, 1024)
    # 24 vectors of 8 bf16 channels at W = 200 (76,800 bytes): 96
    # channels (38,400), whole vectors
    assert warp_mod.fwd_plan(200, 192, torch.bfloat16) == (96, 38400)
    # 5 vectors: ceil(5 / 2) = 3 vectors (24 channels), then 2 (16), 1
    assert warp_mod.fwd_plan(1400, 40, torch.bfloat16) == (16, 44800)
    assert warp_mod.fwd_plan(2000, 40, torch.bfloat16) == (8, 32000)


def test_plan_above_the_default_48_kb_where_one_vector_needs_it():
    """A row whose single vector per pixel takes more than the target
    (but fits the 227 KB a block may use) keeps one vector per pixel."""
    w = 5000  # 5000 * 16 bytes = 80,000
    chunk, smem = warp_mod.fwd_plan(w, 64, torch.float32)
    assert chunk == 4 and smem == 80000 > 48 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_refuses_a_width_past_shared_memory(dtype):
    w = warp_mod.SMEM_MAX // 16 + 1  # one 16-byte vector per pixel too many
    with pytest.raises(ValueError, match="232448 bytes"):
        warp_mod.fwd_plan(w, 64, dtype)
    assert warp_mod.fwd_plan(warp_mod.SMEM_MAX // 16, 64, dtype)[1] \
        == warp_mod.SMEM_MAX // 16 * 16


@pytest.mark.parametrize("batch", [8, 4])
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_launch_plan_follows_the_row_alone(level, batch):
    """The plan of a launch over a tensor: one 16-byte vector per thread
    where every buffer is aligned (one channel where one is not), and
    the chunk of the row's width and channels alone, whatever the batch
    or the card, so the backward's block partials (and d_theta's bits)
    repeat across cards."""
    w, c = LEVELS[level]
    h = {"dec5": 14, "dec4": 30, "dec3": 60, "dec2": 120, "dec1": 240}[level]
    for dtype in (torch.float32, torch.bfloat16):
        size = 4 if dtype == torch.float32 else 2
        img = torch.empty(batch, h, w, c, dtype=dtype)
        out = torch.empty_like(img)
        vec, chunk, smem = warp_mod._plan(img, out)
        assert (vec, chunk, smem) == (16 // size,) + warp_mod.fwd_plan(w, c,
                                                                      dtype)
        # a buffer one element past a 16-byte boundary: one channel a thread
        flat = torch.empty(img.numel() + 1, dtype=dtype)
        shifted = flat[1:].view(batch, h, w, c)
        assert shifted.data_ptr() % 16 != 0
        vec, chunk, smem = warp_mod._plan(img, shifted)
        assert vec == 1
        assert (chunk, smem) == warp_mod.fwd_plan(w, c, dtype, aligned=False)
