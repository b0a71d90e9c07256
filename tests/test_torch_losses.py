"""The port's depth losses and metrics against the JAX package's.

Values and d/dpred of each loss and of ``CombinedDepthLoss`` on the same
numpy inputs, f32: values at rtol 1e-5, gradients at rtol 1e-5 plus an
atol of 1e-6 x the largest |gradient| (sums of 16k terms in another
order). Covered: the empty mask, gt zeros (clipped to the same log
floor, so gradient-loss differences are exactly 0 there and JAX's
abs'(0) = +1 decides), (3, 3) and (B, 3, 3) intrinsics, and
``grad_num_scales`` 1 and 4. ``compute_depth_metrics`` at rtol 1e-5,
including an empty mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadepth_tpu.losses import depth_loss as jl
from cadepth_tpu.metrics.depth_metrics import (
    compute_depth_metrics as jax_metrics,
)
from cadepth_tpu_torch.losses import depth_loss as pl
from cadepth_tpu_torch.metrics.depth_metrics import (
    METRIC_NAMES,
    compute_depth_metrics,
)

B, H, W = 2, 24, 32


def _data(seed, gt_zeros=True):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.2, 9.0, (B, H, W, 1)).astype(np.float32)
    gt = rng.uniform(0.2, 9.0, (B, H, W, 1)).astype(np.float32)
    if gt_zeros:
        gt[:, :6] = 0.0  # whole rows: neighbouring gt zeros
    rgb = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    k = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    k[:, 0, 0] = rng.uniform(20, 40, B)
    k[:, 1, 1] = rng.uniform(20, 40, B)
    k[:, 0, 2], k[:, 1, 2] = W / 2, H / 2
    return pred, gt, rgb, k


def _both(jax_fn, port_fn, pred, *rest):
    """(value, d/dpred) of a scalar loss in both packages."""
    jv, jg = jax.value_and_grad(lambda p: jax_fn(p, *map(jnp.asarray, rest)))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    pv = port_fn(p, *(torch.from_numpy(np.asarray(r)) for r in rest))
    pv.backward()
    return (float(pv.detach()), p.grad.numpy()), (float(jv), np.asarray(jg))


def _close(got, want, what):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-7,
                               err_msg=f"value {what}")
    atol = 1e-6 * float(np.abs(want[1]).max())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=atol,
                               err_msg=f"grad {what}")


@pytest.mark.parametrize("masked", [False, True])
def test_scale_invariant_loss(masked):
    pred, gt, _, _ = _data(1)
    args = (gt, gt > 0.1) if masked else (gt,)
    _close(*_both(jl.scale_invariant_loss, pl.scale_invariant_loss, pred,
                  *args), f"masked={masked}")


@pytest.mark.parametrize("scales", [1, 4])
def test_gradient_matching_loss(scales):
    pred, gt, _, _ = _data(2)
    mask = gt > 0.1
    _close(*_both(
        lambda p, g, m: jl.gradient_matching_loss(p, g, m, scales),
        lambda p, g, m: pl.gradient_matching_loss(p, g, m, scales),
        pred, gt, mask), f"scales={scales}")


def test_gradient_matching_loss_ignores_its_mask():
    pred, gt, _, _ = _data(3)
    p, g = torch.from_numpy(pred), torch.from_numpy(gt)
    assert torch.equal(pl.gradient_matching_loss(p, g, g > 5.0),
                       pl.gradient_matching_loss(p, g, None))


def test_gradient_loss_at_exact_ties_follows_jax():
    """Equal neighbouring predictions over equal gt: every difference of
    differences is exactly 0, where abs'(0) = +1 (JAX) and not 0 (torch)."""
    pred = np.full((1, 8, 8, 1), 2.0, np.float32)
    pred[:, :, 4:] = 3.0
    gt = np.full_like(pred, 4.0)
    got, want = _both(lambda p, g: jl.gradient_matching_loss(p, g, None, 1),
                      lambda p, g: pl.gradient_matching_loss(p, g, None, 1),
                      pred, gt)
    assert np.abs(want[1]).max() > 0
    _close(got, want, "ties")


def test_smoothness_loss():
    pred, _, rgb, _ = _data(4)
    _close(*_both(jl.smoothness_loss, pl.smoothness_loss, pred, rgb),
           "smoothness")


@pytest.mark.parametrize("batched_k", [True, False])
def test_reprojection_loss(batched_k):
    pred, gt, _, k = _data(5)
    kk = k if batched_k else k[0]
    _close(*_both(jl.reprojection_loss, pl.reprojection_loss, pred, gt, kk,
                  gt > 0.1), f"batched_k={batched_k}")


def test_empty_mask_gives_zero_losses():
    pred, gt, rgb, k = _data(6)
    empty = np.zeros_like(gt, bool)
    for j_fn, p_fn in ((jl.scale_invariant_loss, pl.scale_invariant_loss),
                       (jl.reprojection_loss, pl.reprojection_loss)):
        extra = (k,) if j_fn is jl.reprojection_loss else ()
        got, want = _both(lambda p, g, *a: j_fn(p, g, *a),
                          lambda p, g, *a: p_fn(p, g, *a),
                          pred, gt, *extra, empty)
        assert got[0] == want[0] == 0.0
        assert not got[1].any() and not want[1].any()


def test_photometric_stub_is_zero():
    pred, gt, rgb, k = _data(7)
    t = torch.from_numpy
    assert float(pl.reprojection_loss_photometric(
        t(pred), t(gt), t(k), t(rgb), t(rgb))) == 0.0


@pytest.mark.parametrize("with_k", [True, False])
@pytest.mark.parametrize("scales", [1, 4])
def test_combined_loss_and_components(with_k, scales):
    pred, gt, rgb, k = _data(8)
    mask = gt > 0.1
    jloss = jl.CombinedDepthLoss(grad_num_scales=scales)
    ploss = pl.CombinedDepthLoss(grad_num_scales=scales)
    kk = k if with_k else None
    jt, jc = jloss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(rgb),
                   None if kk is None else jnp.asarray(kk), jnp.asarray(mask))
    p = torch.from_numpy(pred).requires_grad_(True)
    pt, pc = ploss(p, torch.from_numpy(gt), torch.from_numpy(rgb),
                   None if kk is None else torch.from_numpy(kk),
                   torch.from_numpy(mask))
    assert set(pc) == set(jc)
    assert ("reproj_loss" in pc) == with_k
    for name in jc:
        np.testing.assert_allclose(float(pc[name].detach()),
                                   float(jc[name]), rtol=1e-5, err_msg=name)
    pt.backward()
    jg = np.asarray(jax.grad(lambda q: jloss(
        q, jnp.asarray(gt), jnp.asarray(rgb),
        None if kk is None else jnp.asarray(kk), jnp.asarray(mask))[0])(
        jnp.asarray(pred)))
    _close((float(pt.detach()), p.grad.numpy()), (float(jt), jg), "combined")


@pytest.mark.parametrize("empty", [False, True])
def test_depth_metrics(empty):
    pred, gt, _, _ = _data(9)
    pred[0, 0, 0] = 50.0  # clamped to max_depth
    if empty:
        gt = np.zeros_like(gt)
    want = jax_metrics(jnp.asarray(pred), jnp.asarray(gt), min_depth=0.1,
                       max_depth=10.0)
    got = compute_depth_metrics(torch.from_numpy(pred), torch.from_numpy(gt),
                                min_depth=0.1, max_depth=10.0)
    assert tuple(got) == METRIC_NAMES and set(want) == set(METRIC_NAMES)
    for k in METRIC_NAMES:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
        if empty:
            assert float(got[k]) == 0.0
