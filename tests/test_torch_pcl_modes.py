"""The PCL's ``gather``, ``auto`` and ``separable`` modes, the separable
warp and the Perspective3DTransformer of the port against the JAX
package's, in f32, from the same converted parameters and numpy inputs.

Forward and gradients (in the features and in every parameter of the
head, through a random cotangent) with ``jax.vjp`` on the JAX side and
autograd on the port's. Tolerances: the gather and separable warps'
outputs 1e-5 (the same f32 operations); ``auto`` on the two-pass side
1e-4, the bound of the two-pass warp against JAX
(``tests/test_torch_layers.py``); feature gradients 1e-4, parameter
gradients 1e-4 of their largest entry (``tests/test_torch_warp_grad.py``
holds d_theta at 2e-5 of its largest entry; the head's dense layers add
f32 sums). ``auto`` must also equal the port's selected branch exactly,
forward and backward.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadepth_tpu.models import pcl as jax_pcl
from cadepth_tpu.ops.affine_warp import separable_affine_warp as jax_separable
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.models.pcl import (
    DEFAULT_ROT_BOUND,
    Perspective3DTransformer,
    PerspectiveCorrectionLayer,
)
from cadepth_tpu_torch.ops.affine_warp import separable_affine_warp

from torch_port_common import init_random, load_port, nchw, nhwc

F32 = jnp.float32
B, H, W, C = 2, 12, 16, 8
# fc_transform bias rotations (rad) under and over auto's bound of 0.05
IN_BOUND, OUT_BOUND = 0.04, 0.07


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    cam = rng.normal(0.0, 0.5, (B, 4)).astype(np.float32)
    cot = rng.normal(size=(B, H, W, C)).astype(np.float32)
    return rng, x, cam, cot


def _port_grads(module, cot_nchw, out):
    """Backward of ``out`` against the cotangent; returns {state_dict
    name: grad}."""
    out.backward(cot_nchw)
    return {k: p.grad.clone() for k, p in module.named_parameters()}


def _assert_param_grads(got, want_tree):
    want = convert.to_torch(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(got) == set(want)
    for k, g in got.items():
        scale = max(float(want[k].abs().max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), want[k].numpy(),
                                   atol=1e-4 * scale, err_msg=k)


def _pcl_setup(mode, rot, seed):
    """(flax module, params with head rotation ``rot``, x, cam, cot)."""
    rng, x, cam, cot = _inputs(seed)
    jm = jax_pcl.PerspectiveCorrectionLayer(C, warp_mode=mode, dtype=F32)
    params, _ = init_random(jm, rng, jnp.asarray(x), jnp.asarray(cam))
    params["fc_transform"]["bias"][4] = rot
    return jm, params, x, cam, cot


def _port_pcl(mode, params, x, cam, cot):
    """(out, {name: grad}, x.grad, intermediates) of the port's PCL."""
    port = load_port(PerspectiveCorrectionLayer(C, warp_mode=mode), params, {})
    tx = nchw(x).requires_grad_(True)
    record = {}
    out = port(tx, torch.from_numpy(cam), record)
    grads = _port_grads(port, nchw(cot), out)
    return out.detach(), grads, tx.grad, record


def _jax_pcl(jm, params, x, cam, cot):
    """(out, param grads, x grads, pcl_max_rot) of the JAX PCL, jitted."""

    def fn(p, xx):
        out, inter = jm.apply({"params": p}, xx, jnp.asarray(cam),
                              mutable=["intermediates"])
        return out, inter["intermediates"]["pcl_max_rot"][0]

    def run(p, xx, ct):
        out, vjp, rot = jax.vjp(fn, p, xx, has_aux=True)
        return (out,) + vjp(ct) + (rot,)

    out, dp, dx, rot = jax.jit(run)(params, jnp.asarray(x), jnp.asarray(cot))
    return np.asarray(out), dp, np.asarray(dx), float(rot)


@pytest.mark.parametrize("mode,rot", [("gather", IN_BOUND),
                                      ("separable", IN_BOUND),
                                      ("auto", IN_BOUND),
                                      ("auto", OUT_BOUND)])
def test_pcl_mode_matches_jax(mode, rot):
    jm, params, x, cam, cot = _pcl_setup(mode, rot, seed=0)
    want, want_dp, want_dx, want_rot = _jax_pcl(jm, params, x, cam, cot)
    out, grads, dx, record = _port_pcl(mode, params, x, cam, cot)
    two_pass = mode == "auto" and rot < DEFAULT_ROT_BOUND
    np.testing.assert_allclose(nhwc(out), want, atol=1e-4 if two_pass
                               else 1e-5)
    np.testing.assert_allclose(nhwc(dx), want_dx, atol=1e-4)
    _assert_param_grads(grads, want_dp)
    assert len(record["pcl_max_rot"]) == 1
    got_rot = float(record["pcl_max_rot"][0].detach())
    np.testing.assert_allclose(got_rot, want_rot, rtol=1e-6)
    assert abs(want_rot - rot) < 0.01
    # the head's gradient really reaches theta
    assert float(grads["fc_transform.weight"].abs().max()) > 1e-4


@pytest.mark.parametrize("rot,branch", [(IN_BOUND, "two_pass"),
                                        (OUT_BOUND, "gather")])
def test_auto_equals_the_selected_branch(rot, branch):
    """auto's output and gradients are its branch's, bit for bit."""
    _, params, x, cam, cot = _pcl_setup("auto", rot, seed=3)
    out_a, g_a, dx_a, _ = _port_pcl("auto", params, x, cam, cot)
    out_b, g_b, dx_b, _ = _port_pcl(branch, params, x, cam, cot)
    torch.testing.assert_close(out_a, out_b, rtol=0, atol=0)
    torch.testing.assert_close(dx_a, dx_b, rtol=0, atol=0)
    for k in g_a:
        torch.testing.assert_close(g_a[k], g_b[k], rtol=0, atol=0)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_separable_warp_matches_jax(padding_mode):
    rng, x, _, cot = _inputs(5)
    theta = np.array([[[1.2, 0.0, 0.15], [0.0, 0.85, -0.3]],
                      [[0.9, 0.03, -0.4], [-0.02, 1.1, 0.25]]], np.float32)

    def run(img, th, ct):
        out, vjp = jax.vjp(lambda i, t: jax_separable(i, t, padding_mode),
                           img, th)
        return (out,) + vjp(ct)

    want, want_dx, want_dth = jax.jit(run)(jnp.asarray(x), jnp.asarray(theta),
                                           jnp.asarray(cot))
    tx = torch.from_numpy(x).requires_grad_(True)
    tth = torch.from_numpy(theta).requires_grad_(True)
    got = separable_affine_warp(tx, tth, padding_mode)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               atol=1e-4)
    want_dth = np.asarray(want_dth)
    np.testing.assert_allclose(tth.grad.numpy(), want_dth,
                               atol=1e-4 * np.abs(want_dth).max())
    assert np.abs(want_dth).max() > 1.0


def test_perspective_3d_transformer_matches_jax():
    rng, x, cam, cot = _inputs(7)
    rays = rng.normal(0.0, 0.6, (B, H, W, 3)).astype(np.float32)
    jm = jax_pcl.Perspective3DTransformer(C, dtype=F32)
    args = (jnp.asarray(cam), jnp.asarray(rays))
    params, _ = init_random(jm, rng, jnp.asarray(x), *args)

    def run(p, xx, ct):
        out, vjp = jax.vjp(lambda q, xi: jm.apply({"params": q}, xi, *args),
                           p, xx)
        return (out,) + vjp(ct)

    want, want_dp, want_dx = jax.jit(run)(params, jnp.asarray(x),
                                          jnp.asarray(cot))
    port = load_port(Perspective3DTransformer(C), params, {})
    tx = nchw(x).requires_grad_(True)
    out = port(tx, torch.from_numpy(cam), nchw(rays))
    grads = _port_grads(port, nchw(cot), out)
    np.testing.assert_allclose(nhwc(out), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(nhwc(tx.grad), np.asarray(want_dx), atol=1e-4)
    _assert_param_grads(grads, want_dp)
    # the rays and the translation displace the samples
    assert np.abs(nhwc(out) - x).max() > 0.1
