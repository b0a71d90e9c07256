"""The plain banded affine warp (``ops/banded_affine_warp.py``, the plain
version of ``csrc/banded_affine_warp.cu``) against the JAX package's
``pallas_affine_warp`` in interpret mode, on the same numpy inputs.

The cases are ``tests/test_pallas.py``'s four thetas at (2, 12, 40, 16)
and (2, 24, 64, 8), rotations of 0.35 and 0.6 rad at (1, 48, 64, 16),
whose spans (16.2 and 26.7 rows) pass the 16-row band, so both sides
drop the same rows and differ from ``grid_sample`` by up to ~3, and one
bf16 case.

Tolerances: f32 atol 1e-6, except for the in-band rotation theta at
batch 2. There XLA's CPU compiler computes the positions as
``fma(ax, o, bx*j) + cx`` (it does at batch 2 and not at batch 1: a
choice of its fusion pass), which moves u and v by an ulp and the output
by up to ulp(u) times the step between neighbouring pixels; the port
keeps the separate multiply and add that the reference writes (and that
the kernel repeats with ``__fmul_rn``/``__fadd_rn``). That case is held
at 4 * ulp(W) * max|img|, and the cause is shown: a numpy bilinear sum in
the same f32 order matches JAX to 1e-6 from the FMA positions and the
port to 1e-6 from the written ones. At batch 1, where XLA keeps the two
operations apart, the case is held at 1e-6.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadepth_tpu.ops.grid_sample import affine_grid as jax_affine_grid
from cadepth_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from cadepth_tpu.ops.pallas.affine_warp import max_rotation_rows as jax_mrr
from cadepth_tpu.ops.pallas.affine_warp import pallas_affine_warp
from cadepth_tpu_torch.ops import banded_affine_warp as baw

THETAS = {  # tests/test_pallas.py::test_affine_warp_matches_grid_sample
    "identity": [[1, 0, 0], [0, 1, 0.0]],
    "zoom_shift": [[1.3, 0, 0.2], [0, 0.7, -0.3]],
    "rotation": [[0.999, -0.037, 0], [0.037, 0.999, 0.0]],
    "oob_translate": [[1, 0, 0.9], [0, 1, 0.9]],
}


def _rot(rad):
    return [[math.cos(rad), -math.sin(rad), 0.0],
            [math.sin(rad), math.cos(rad), 0.0]]


def _case(shape, th, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=shape).astype(np.float32)
    theta = np.tile(np.asarray(th, np.float32)[None], (shape[0], 1, 1))
    jimg = jnp.asarray(img).astype(dtype)
    want = np.asarray(pallas_affine_warp(jimg, jnp.asarray(theta),
                                         interpret=True), np.float32)
    timg = torch.from_numpy(img)
    if dtype != np.float32:
        timg = timg.to(torch.bfloat16)
    got = baw.banded_affine_warp(timg, torch.from_numpy(theta))
    assert got.dtype == timg.dtype and got.shape == timg.shape
    return img, theta, got.float().numpy(), want


def _bilinear_np(img, u, v):
    """Bilinear zeros-padded sampling of img (B, H, W, C) f32 at source
    positions u, v (B, H, W) f32, summed in f32 in the band's order: row
    floor(v), then floor(v) + 1, each over columns x0, x0 + 1. In band
    the rows the band adds beside these carry weight 0."""
    f32 = np.float32
    bsz, h, w, _ = img.shape
    bi = np.arange(bsz)[:, None, None]
    x0 = np.floor(u)
    wx1 = u - x0
    acc = np.zeros(img.shape, f32)
    for dy in (0, 1):
        y = np.floor(v) + f32(dy)
        wy = np.maximum(f32(0), f32(1) - np.abs(v - y))
        for xc, wxc in ((x0, f32(1) - wx1), (x0 + f32(1), wx1)):
            ok = (xc >= 0) & (xc <= w - 1) & (y >= 0) & (y <= h - 1)
            wgt = np.where(ok, wxc * wy, f32(0))
            tap = img[bi, np.clip(y, 0, h - 1).astype(np.int64),
                      np.clip(xc, 0, w - 1).astype(np.int64)]
            acc = acc + tap * wgt[..., None]
    return acc


def _positions(theta, h, w, fused):
    """u, v (B, H, W) f32 from the port's coefficients: ``(a*o + b*j) +
    c`` with each operation rounded, or with ``a*o + b*j`` rounded once
    (an FMA; f64 holds the f32 product a*o exactly)."""
    ax, bx, cx, ay, by, cy = (c.numpy()[:, None, None] for c in
                              baw.pixel_coeffs(torch.from_numpy(theta), h, w))
    o = np.arange(w, dtype=np.float32)[None, None, :]
    j = np.arange(h, dtype=np.float32)[None, :, None]
    out = []
    for a, b, c in ((ax, bx, cx), (ay, by, cy)):
        bj = b * j
        if fused:
            ao_bj = (a.astype(np.float64) * o + bj).astype(np.float32)
        else:
            ao_bj = a * o + bj
        out.append(ao_bj + c)
    return out


@pytest.mark.parametrize("name", list(THETAS))
@pytest.mark.parametrize("shape", [(2, 12, 40, 16), (2, 24, 64, 8)])
def test_plain_matches_pallas_interpret(shape, name):
    img, theta, got, want = _case(shape, THETAS[name], seed=sum(shape))
    h, w = shape[1], shape[2]
    assert float(baw.max_rotation_rows(torch.from_numpy(theta), h, w).max()) \
        + 2 <= baw.BAND_S
    atol = 1e-6
    if name == "rotation":
        atol = 4 * float(np.spacing(np.float32(w))) * np.abs(img).max()
        # the whole difference is the FMA in JAX's positions
        np.testing.assert_allclose(
            want, _bilinear_np(img, *_positions(theta, h, w, True)),
            atol=1e-6)
        np.testing.assert_allclose(
            got, _bilinear_np(img, *_positions(theta, h, w, False)),
            atol=1e-6)
    np.testing.assert_allclose(got, want, atol=atol)


def test_in_band_rotation_at_batch_one_is_exact():
    _, _, got, want = _case((1, 24, 64, 8), THETAS["rotation"], seed=5)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("rad", [0.35, 0.6])
def test_out_of_band_rows_are_dropped_as_in_jax(rad):
    h, w = 48, 64
    img, theta, got, want = _case((1, h, w, 16), _rot(rad), seed=11)
    np.testing.assert_allclose(got, want, atol=1e-6)
    span = float(baw.max_rotation_rows(torch.from_numpy(theta), h, w)[0])
    assert span + 2 > baw.BAND_S
    # the truncation is the function: grid_sample differs by far more
    ref = np.asarray(jax_grid_sample(
        jnp.asarray(img), jax_affine_grid(jnp.asarray(theta), h, w)))
    assert np.abs(got - ref).max() > 1.0


def test_bf16_matches():
    _, _, got, want = _case((2, 12, 40, 16), THETAS["zoom_shift"], seed=3,
                            dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_max_rotation_rows_matches():
    rng = np.random.default_rng(4)
    theta = rng.normal(0.0, 0.3, (5, 2, 3)).astype(np.float32)
    for h, w in ((12, 40), (240, 320)):
        np.testing.assert_array_equal(
            baw.max_rotation_rows(torch.from_numpy(theta), h, w).numpy(),
            np.asarray(jax_mrr(jnp.asarray(theta), h, w)))


def test_forward_only():
    img = torch.zeros(1, 4, 8, 2, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        baw.banded_affine_warp(img, torch.eye(2, 3)[None])
    with torch.no_grad():
        assert baw.banded_affine_warp(img, torch.eye(2, 3)[None]).shape \
            == img.shape
