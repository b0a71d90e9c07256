"""The port's fused depth-loss op against the JAX package's.

``silog_reproj_losses`` and ``fused_depth_loss_stats`` of
``cadepth_tpu_torch.ops.fused_loss`` take their plain versions on the
CPU; the JAX op runs in Pallas interpret mode, as ``test_pallas.py`` runs
it. The five checks of ``test_pallas.py``'s fused-loss tests, each on
both sides: the losses against JAX's op and against the port's
``scale_invariant_loss`` and ``reprojection_loss`` (rel 1e-5), the
gradient (rtol 1e-4, atol 1e-7), the statistics (rel 1e-5; the count
exactly), the empty mask (exact zeros) and an odd height. The CUDA
kernels are held against the plain versions on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadepth_tpu.ops.pallas.fused_loss import (
    fused_depth_loss_stats as jax_stats,
    silog_reproj_losses as jax_losses,
)
from cadepth_tpu_torch.losses.depth_loss import (
    reprojection_loss,
    scale_invariant_loss,
)
from cadepth_tpu_torch.ops import fused_loss as fl


def _data(rng, b=2, h=24, w=40):
    """test_pallas.py's make_data: w = 40 not lane-aligned, ~10 % of gt
    set to 0 (masked out), one pixel K."""
    pred = rng.uniform(0.2, 9.0, size=(b, h, w, 1)).astype(np.float32)
    gt = rng.uniform(0.2, 9.0, size=(b, h, w, 1)).astype(np.float32)
    gt[gt < 1.0] = 0.0
    k4 = np.tile(np.array([[250.0, 260.0, w / 2, h / 2]], np.float32), (b, 1))
    return pred, gt, k4


def _kmat(k4):
    k = np.tile(np.eye(3, dtype=np.float32), (k4.shape[0], 1, 1))
    k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2] = k4.T
    return torch.from_numpy(k)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", [(2, 24, 40), (1, 21, 30)])
def test_losses_match_jax_and_reference(shape):
    """(2, 24, 40) and the odd height (1, 21, 30)."""
    pred, gt, k4 = _data(np.random.default_rng(0), *shape)
    si_j, rep_j = jax_losses(jnp.asarray(pred), jnp.asarray(gt),
                             jnp.asarray(k4), interpret=True)
    p, g, k = _t(pred, gt, k4)
    si, rep = fl.silog_reproj_losses(p, g, k)
    assert si.dtype == rep.dtype == torch.float32 and si.dim() == 0
    assert float(si) == pytest.approx(float(si_j), rel=1e-5)
    assert float(rep) == pytest.approx(float(rep_j), rel=1e-5)
    assert float(si) == pytest.approx(float(scale_invariant_loss(p, g)),
                                      rel=1e-5)
    assert float(rep) == pytest.approx(
        float(reprojection_loss(p, g, _kmat(k4))), rel=1e-5)
    # (B, H, W) takes the same path
    si3, rep3 = fl.silog_reproj_losses(p[..., 0], g[..., 0], k)
    assert float(si3) == float(si) and float(rep3) == float(rep)


def test_gradient_matches_jax_and_reference():
    pred, gt, k4 = _data(np.random.default_rng(1))

    def loss_j(x):
        si, rep = jax_losses(x, jnp.asarray(gt), jnp.asarray(k4),
                             interpret=True)
        return si + 0.01 * rep

    want = np.asarray(jax.grad(loss_j)(jnp.asarray(pred)))
    p, g, k = _t(pred, gt, k4)
    x = p.clone().requires_grad_(True)
    si, rep = fl.silog_reproj_losses(x, g, k)
    (si + 0.01 * rep).backward()
    got = x.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    y = p.clone().requires_grad_(True)
    (scale_invariant_loss(y, g)
     + 0.01 * reprojection_loss(y, g, _kmat(k4))).backward()
    np.testing.assert_allclose(got, y.grad.numpy(), rtol=1e-4, atol=1e-7)


def test_stats_values():
    pred, gt, k4 = _data(np.random.default_rng(2))
    p2, g2 = pred[..., 0], gt[..., 0]
    want = np.asarray(jax_stats(jnp.asarray(p2), jnp.asarray(g2),
                                jnp.asarray(k4), True))
    got = fl.fused_depth_loss_stats(*_t(p2, g2, k4)).numpy()
    assert got.shape == (4,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)
    mask = g2 > 1e-6
    d = (np.log(np.clip(p2, 1e-6, 1000))
         - np.log(np.clip(g2, 1e-6, 1000)))[mask]
    assert got[0] == pytest.approx(d.sum(), rel=1e-4)
    assert got[1] == pytest.approx((d * d).sum(), rel=1e-4)
    assert got[2] == mask.sum()


def test_empty_mask_gives_zeros():
    z = np.zeros((1, 8, 128, 1), np.float32)
    k4 = np.ones((1, 4), np.float32) * 100.0
    si_j, rep_j = jax_losses(jnp.asarray(z), jnp.asarray(z), jnp.asarray(k4),
                             interpret=True)
    x = torch.from_numpy(z).requires_grad_(True)
    si, rep = fl.silog_reproj_losses(x, torch.from_numpy(z),
                                     torch.from_numpy(k4))
    assert float(si.detach()) == float(si_j) == 0.0
    assert float(rep.detach()) == float(rep_j) == 0.0
    (si + rep).backward()
    assert not x.grad.any()


def test_bf16_pred_gradient_keeps_its_dtype():
    pred, gt, k4 = _data(np.random.default_rng(3))
    x = torch.from_numpy(pred).to(torch.bfloat16).requires_grad_(True)
    fl.launches = fl.bwd_launches = 0
    si, rep = fl.silog_reproj_losses(x, *_t(gt, k4))
    (si + rep).backward()
    assert x.grad.dtype == torch.bfloat16
    assert fl.launches == fl.bwd_launches == 0  # plain versions on the CPU
