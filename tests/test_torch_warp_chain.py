"""The warps' chain from line-coefficient partials to d_theta.

The theta kernel of ``csrc/warp_common.cuh`` chains the six per-batch
partials (s_a, s_b, s_c, s_p, s_q, s_r) of the loss with respect to the
line coefficients [A, B, C, p, q, r] to d_theta in closed form on the
card, for the two-pass and the banded warp; ``chain_theta_closed`` is
that closed form in the kernel's f32 operation order, and both plain
backwards use it. Here it is held against the autograd form
``chain_theta`` (``tests/torch_port_common.py``) and against the JAX
package's chain (``jax.vjp`` of ``affine_pixel_coeffs`` and of p, q, r
through A_safe, as ``cadepth_tpu/ops/pallas/two_pass_warp.py:
_trainable_bwd`` chains its partials), on partials drawn with numpy from
a seed. Tolerance: 1e-6
times max|d_theta| of each batch element, f32 (the forms differ only in
the order of a few f32 operations). The thetas cover the identity, a
small rotation, zooms, a 90 degree rotation (A = 0, clamped), A = +-5e-4
(clamped: no gradient through A_safe) and A = +-1e-3 exactly (not
clamped), under both ``align_corners``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadepth_tpu.ops.affine_warp import affine_pixel_coeffs as jax_coeffs
from cadepth_tpu_torch.ops.affine_warp import chain_theta_closed
from torch_port_common import chain_theta  # also: one torch thread a process

ROT = 0.04
THETAS = {
    "identity": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
    "rotation_0.04": [[math.cos(ROT), -math.sin(ROT), 0.02],
                      [math.sin(ROT), math.cos(ROT), -0.01]],
    "zoom_0.3": [[0.3, 0.0, 0.1], [0.0, 0.3, -0.1]],
    "zoom_3": [[3.0, 0.0, 0.1], [0.0, 3.0, -0.1]],
    "rotation_90": [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0]],
    "a_5e-4": [[5e-4, 0.1, 0.05], [0.2, 0.9, 0.0]],
    "a_-5e-4": [[-5e-4, 0.1, 0.05], [0.2, 0.9, 0.0]],
    "a_1e-3": [[1e-3, 0.1, 0.05], [0.2, 0.9, 0.0]],
    "a_-1e-3": [[-1e-3, 0.1, 0.05], [0.2, 0.9, 0.0]],
}
RTOL_OF_MAX = 1e-6
# (H, W): a decoder level of the flagship, and a small odd one
SIZES = [(240, 320), (15, 20)]


def _jax_chain(theta, partials, h, w, align_corners):
    """d_theta as _trainable_bwd chains its accumulated partials."""

    def h_abc(th):
        a, b, c, _, _, _ = jax_coeffs(th, h, w, align_corners)
        return a, b, c

    def g_pqr(th):
        a, b, c, d, e, f = jax_coeffs(th, h, w, align_corners)
        a_safe = jnp.where(jnp.abs(a) < 1e-3,
                           jnp.where(a < 0, -1e-3, 1e-3), a)
        doa = d / a_safe
        return doa, e - doa * b, f - doa * c

    th = jnp.asarray(theta)
    s = jnp.asarray(partials)
    _, vjp_h = jax.vjp(h_abc, th)
    _, vjp_g = jax.vjp(g_pqr, th)
    d = (vjp_h((s[:, 0], s[:, 1], s[:, 2]))[0]
         + vjp_g((s[:, 3], s[:, 4], s[:, 5]))[0])
    return np.asarray(d, np.float32)


def _close(got, want, what):
    scale = np.abs(want).reshape(len(want), -1).max(1)[:, None, None]
    err = np.abs(got - want) / np.maximum(scale, 1e-30)
    assert err.max() <= RTOL_OF_MAX, (what, float(err.max()))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_closed_chain_matches_autograd_and_jax(size, align_corners):
    h, w = size
    rng = np.random.default_rng(h * 7 + int(align_corners))
    names = sorted(THETAS)
    theta = np.asarray([THETAS[n] for n in names], np.float32)
    # partials of the sizes a decoder level gives: sums over H*W*C terms
    partials = (rng.normal(size=(len(names), 6))
                * rng.uniform(1.0, 1e4, size=(len(names), 6))) \
        .astype(np.float32)
    th, p = torch.from_numpy(theta), torch.from_numpy(partials)
    got = chain_theta_closed(th, p, h, w, align_corners)
    assert got.dtype == torch.float32 and got.shape == (len(names), 2, 3)
    got = got.numpy()
    _close(got, chain_theta(th, p, h, w, align_corners).numpy(),
           f"autograd {names} {size} ac={align_corners}")
    _close(got, _jax_chain(theta, partials, h, w, align_corners),
           f"jax {names} {size} ac={align_corners}")


def test_clamped_a_passes_no_gradient_through_a_safe():
    """Where |A| < 1e-3, d_theta[0, 0] is s_a alone (A enters only as
    itself); at |A| = 1e-3 exactly the clamp is off and p's gradient
    reaches A."""
    partials = torch.tensor([[1.0, 0.0, 0.0, 2.0, 0.0, 0.0]])
    for a, clamped in ((5e-4, True), (-5e-4, True), (0.0, True),
                       (1e-3, False), (-1e-3, False)):
        theta = torch.tensor([[[a, 0.1, 0.05], [0.2, 0.9, 0.0]]])
        d = chain_theta_closed(theta, partials, 24, 32, False)
        assert (float(d[0, 0, 0]) == 1.0) == clamped, (a, d)
