"""The port's ``affine_grid`` and ``grid_sample`` (``ops/grid_sample.py``)
against the JAX package's, on the same numpy inputs.

Forward in f32 at atol 1e-5 (the same f32 operations; XLA's CPU compiler
may fuse a multiply and an add into one FMA, an ulp of a position), the
gradients in the image and in the grid at atol 1e-4 through a random
cotangent, both padding modes and both ``align_corners``; one bf16 case
at the bf16 atol of the warp tests. Grids reach past [-1, 1], so
zeros-padded taps and border clamps both occur.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadepth_tpu.ops.grid_sample import affine_grid as jax_affine_grid
from cadepth_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from cadepth_tpu_torch.ops.grid_sample import (
    affine_grid,
    gather_affine_warp,
    grid_sample,
)

B, H, W, C = 2, 9, 11, 5
HO, WO = 7, 8


def _inputs(seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, H, W, C)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (B, HO, WO, 2)).astype(np.float32)
    cot = rng.normal(size=(B, HO, WO, C)).astype(np.float32)
    return img, grid, cot


@pytest.mark.parametrize("align_corners", [False, True])
def test_affine_grid_matches(align_corners):
    theta = np.random.default_rng(0).normal(0.0, 0.6, (3, 2, 3)) \
        .astype(np.float32)
    for h, w in ((7, 12), (1, 5), (16, 16)):
        want = np.asarray(jax_affine_grid(jnp.asarray(theta), h, w,
                                          align_corners))
        got = affine_grid(torch.from_numpy(theta), h, w, align_corners)
        assert got.dtype == torch.float32 and got.shape == (3, h, w, 2)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6,
                                   err_msg=f"{h}x{w}")


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_forward_and_gradients_match(padding_mode, align_corners):
    img, grid, cot = _inputs(1 + 2 * align_corners
                             + (padding_mode == "border"))

    def jax_fn(i, g):
        return jax_grid_sample(i, g, padding_mode, align_corners)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(img), jnp.asarray(grid))
    want_di, want_dg = vjp(jnp.asarray(cot))

    ti = torch.from_numpy(img).requires_grad_(True)
    tg = torch.from_numpy(grid).requires_grad_(True)
    got = grid_sample(ti, tg, padding_mode, align_corners)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(want_di), atol=1e-4)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(want_dg), atol=1e-4)
    # out-of-range taps really occur
    assert (np.abs(grid) > 1.0).any()
    assert np.abs(tg.grad.numpy()).max() > 1e-2


def test_grid_sample_bf16_matches():
    img, grid, _ = _inputs(7)
    img16 = jnp.asarray(img).astype(jnp.bfloat16)
    want = np.asarray(jax_grid_sample(img16, jnp.asarray(grid)),
                      np.float32)
    got = grid_sample(torch.from_numpy(img).to(torch.bfloat16),
                      torch.from_numpy(grid))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05)


def test_gather_affine_warp_is_grid_sample_over_affine_grid():
    img, _, _ = _inputs(9)
    theta = np.array([[[1.04, -0.05, 0.03], [0.04, 0.95, -0.02]]] * B,
                     np.float32)
    ji = jnp.asarray(img)
    want = np.asarray(jax_grid_sample(
        ji, jax_affine_grid(jnp.asarray(theta), H, W)))
    got = gather_affine_warp(torch.from_numpy(img), torch.from_numpy(theta))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
