"""The banded ("fused") warp's launch plan and its plain backward's chain.

``fused_plan`` chooses how many channels of a whole row one block of the
banded kernels holds: the two-pass forward's chunk (``fwd_plan``),
halved again in whole 16-byte vectors while a launch has fewer than
``MIN_BLOCKS`` blocks and each thread of a block keeps two items. It
depends on the shape alone, so the backward's block partials, and
d_theta's bits, are the same on every card. Needs no card.

``fused_warp_plain_bwd`` chains its six partials to d_theta with
``chain_theta_closed`` (the theta kernel's f32 order); here that is held
against the autograd chain through ``warp_coeffs`` (1e-6 of max|d_theta|,
the bound of ``test_torch_warp_chain.py``) and the whole plain backward
against ``pallas_fused_warp_trainable``'s VJP in Pallas interpret mode
(d_img 1e-4, d_theta over its largest |entry| 2e-5, the bounds of
``test_pallas.py``), in band and out of band.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from cadepth_tpu.ops.pallas.fused_warp import pallas_fused_warp_trainable
from cadepth_tpu_torch.ops import fused_warp as fw
from cadepth_tpu_torch.ops import two_pass_warp as tpw
from torch_port_common import chain_theta  # also: one torch thread a process

# the flagship's five decoder maps (f=64, 240x320): (H, W, C)
LEVELS = {"dec5": (14, 20, 1024), "dec4": (30, 40, 512),
          "dec3": (60, 80, 256), "dec2": (120, 160, 128),
          "dec1": (240, 320, 64)}
# (vec, c_chunk) at the serving batch (8) and the training batch (4):
# dec1 keeps the two-pass chunk (a whole bf16 row, half an f32 row); the
# smaller levels split until 256 blocks, or until a block's 256 threads
# would have fewer than two items each (dec5 bf16 at B=4: 224 blocks of
# 640 items)
PLANS = {
    (8, torch.bfloat16): {"dec5": (8, 256), "dec4": (8, 256),
                          "dec3": (8, 256), "dec2": (8, 128),
                          "dec1": (8, 64)},
    (4, torch.bfloat16): {"dec5": (8, 256), "dec4": (8, 128),
                          "dec3": (8, 128), "dec2": (8, 128),
                          "dec1": (8, 64)},
    (8, torch.float32): {"dec5": (4, 256), "dec4": (4, 256),
                         "dec3": (4, 128), "dec2": (4, 64),
                         "dec1": (4, 32)},
    (4, torch.float32): {"dec5": (4, 128), "dec4": (4, 128),
                         "dec3": (4, 128), "dec2": (4, 64),
                         "dec1": (4, 32)},
}
ROT = 0.2
CASES = {
    "identity": [[1, 0, 0], [0, 1, 0.0]],
    "rotation": [[0.999, -0.03, 0.02], [0.03, 0.999, 0.01]],
    "zoom_shift": [[0.8, 0, 0.1], [0, 1.2, -0.2]],
    "rot_0.2": [[np.cos(ROT), -np.sin(ROT), 0.0],
                [np.sin(ROT), np.cos(ROT), 0.0]],
}


def _blocks(b, h, c, chunk):
    return b * h * -(-c // chunk)


@pytest.mark.parametrize("batch,dtype", sorted(PLANS, key=str))
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_plan_at_the_decoder_levels(level, batch, dtype):
    h, w, c = LEVELS[level]
    size = 4 if dtype == torch.float32 else 2
    vec, chunk, smem = fw.fused_plan(batch, h, w, c, dtype)
    assert (vec, chunk) == PLANS[batch, dtype][level]
    assert vec == 16 // size and chunk % vec == 0 and c % chunk == 0
    assert smem == w * chunk * size <= tpw.SMEM_TARGET
    two_pass_chunk = tpw.fwd_plan(w, c, dtype)[0]
    assert chunk <= two_pass_chunk
    # split only while the launch is short of blocks, and never past two
    # items (a pixel's vector each) per thread
    assert chunk == two_pass_chunk or \
        _blocks(batch, h, c, chunk * 2) < fw.MIN_BLOCKS
    assert w * (chunk // vec) >= 2 * fw.THREADS or chunk == two_pass_chunk
    half = max(vec, chunk // 2)
    assert _blocks(batch, h, c, chunk) >= fw.MIN_BLOCKS or half == chunk \
        or w * (half // vec) < 2 * fw.THREADS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_at_odd_channel_counts(dtype):
    """C = 3 (one channel a thread, rows too short to split), C = 12
    (whole f32 vectors, a ragged last chunk of 4), and an unaligned
    buffer."""
    size = 4 if dtype == torch.float32 else 2
    assert fw.fused_plan(2, 15, 20, 3, dtype) == (1, 3, 20 * 3 * size)
    vec, chunk, smem = fw.fused_plan(1, 8, 300, 12, dtype)
    if dtype == torch.float32:
        # 12 -> 8 (ceil(6 / 4) vectors): 600 items a block; 4 would leave
        # 300, under two a thread
        assert (vec, chunk) == (4, 8)
    else:
        # 12 channels are no whole bf16 vector: one a thread, 12 -> 6 ->
        # 3, each chunk keeping >= 512 items of 300 pixels
        assert (vec, chunk) == (1, 3)
    assert smem == 300 * chunk * size
    assert fw.fused_plan(8, 240, 320, 64, dtype, aligned=False)[0] == 1
    img = torch.empty(4, 30, 40, 512, dtype=dtype)
    flat = torch.empty(img.numel() + 1, dtype=dtype)
    shifted = flat[1:].view(img.shape)
    assert fw._plan(img, torch.empty_like(img)) == \
        fw.fused_plan(4, 30, 40, 512, dtype)
    assert fw._plan(img, shifted) == \
        fw.fused_plan(4, 30, 40, 512, dtype, aligned=False)


def test_plan_needs_no_card(monkeypatch):
    """The plan reads nothing of the card: with every CUDA query made to
    raise, it is the same as without."""
    want = {lv: fw.fused_plan(4, *LEVELS[lv], torch.bfloat16)
            for lv in LEVELS}

    def no_card(*args, **kwargs):
        raise AssertionError("the plan asked the card")

    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert {lv: fw.fused_plan(4, *LEVELS[lv], torch.bfloat16)
            for lv in LEVELS} == want


def _theta(name, b, rng):
    t = np.tile(np.asarray(CASES[name], np.float32)[None], (b, 1, 1))
    if name not in ("identity", "rot_0.2"):
        t = t + rng.normal(scale=0.01, size=t.shape)
    return t.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_vjp():
    def vjp(im, t, g):
        _, back = jax.vjp(lambda a, b: pallas_fused_warp_trainable(
            a, b, "zeros", False, True), im, t)
        return back(g)
    return jax.jit(vjp)


@pytest.mark.parametrize("shape", [(2, 48, 64, 8), (4, 14, 20, 8)])
def test_plain_backward_chains_as_autograd_and_jax(shape, monkeypatch):
    rng = np.random.default_rng(11)
    img = rng.normal(size=shape).astype(np.float32)
    grad = rng.normal(size=shape).astype(np.float32)
    seen = []
    closed = fw.chain_theta_closed

    def recording(theta, partials, h, w, align_corners):
        seen.append((theta, partials, h, w, align_corners))
        return closed(theta, partials, h, w, align_corners)

    monkeypatch.setattr(fw, "chain_theta_closed", recording)
    for name in CASES:
        theta = _theta(name, shape[0], rng)
        im, th = torch.from_numpy(img), torch.from_numpy(theta)
        _, v = fw.fused_warp_plain_fwd(im, th)
        d_img, d_theta = fw.fused_warp_plain_bwd(im, v, th,
                                                 torch.from_numpy(grad))
        # the closed chain against autograd through warp_coeffs
        auto = chain_theta(*seen.pop())
        scale = auto.abs().reshape(shape[0], -1).max(1).values
        err = ((d_theta - auto).abs().reshape(shape[0], -1).max(1).values
               / scale.clamp_min(1e-30))
        assert err.max().item() <= 1e-6, (shape, name, err)
        # the whole plain backward against JAX's Pallas VJP
        want_img, want_theta = map(np.asarray, _jax_vjp()(img, theta, grad))
        np.testing.assert_allclose(d_img.numpy(), want_img, atol=1e-4,
                                   err_msg=f"d_img {shape} {name}")
        top = float(np.abs(want_theta).max()) + 1e-6
        np.testing.assert_allclose(d_theta.numpy() / top, want_theta / top,
                                   atol=2e-5,
                                   err_msg=f"d_theta {shape} {name}")
