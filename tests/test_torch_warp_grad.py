"""The backward of the port's two-pass warp against the JAX package's.

On the CPU :func:`two_pass_warp` goes through ``TwoPassWarp``, whose
backward is the plain version ``two_pass_affine_warp_plain_bwd``. Its
gradients of a ``sum(sin(out))`` loss (so the cotangent is not constant)
are held against the XLA ``two_pass_affine_warp`` custom VJP at
"highest" precision and the Pallas ``pallas_two_pass_warp_trainable`` in
interpret mode: d_img at atol 1e-4, d_theta divided by its largest
|entry| at atol 2e-5, the tolerances ``test_pallas.py`` holds the Pallas
backward to, and one bf16 case at a looser tolerance. The exact-kink
thetas (identity, axis scales, a pure vertical shear) put every position
on the integer grid, where JAX's conventions (abs'(0) = +1, half weight
at ties) decide the gradient.
The CUDA kernels are held against the plain backward on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadepth_tpu.ops.affine_warp import two_pass_affine_warp
from cadepth_tpu.ops.pallas.two_pass_warp import pallas_two_pass_warp_trainable
from cadepth_tpu_torch.ops import two_pass_warp as warp_mod
from cadepth_tpu_torch.ops.affine_warp import (
    two_pass_affine_warp_plain_bwd,
    two_pass_affine_warp_plain_fwd,
)

# test_pallas.py's gradient cases (jittered), its kink cases (exact), and
# a collapsed x-scale (|A| < 1e-3) where A_safe clamps
JITTERED = {
    "near_identity": [[1.0, -0.02, 0.05], [0.02, 0.97, -0.03]],
    "zoom": [[0.8, 0.0, 0.1], [0.0, 1.2, -0.2]],
}
KINKS = {
    "identity": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
    "scale_x": [[0.98, 0.0, 0.0], [0.0, 1.0, 0.0]],
    "scale_y": [[1.0, 0.0, 0.0], [0.0, 1.02, 0.0]],
    "shear_d": [[1.0, 0.0, 0.0], [0.01, 1.0, 0.0]],
}
A_TINY = [[4e-4, 0.1, 0.05], [0.2, 0.9, 0.0]]


def _theta(th, b, rng, jitter):
    t = np.tile(np.asarray(th, np.float32)[None], (b, 1, 1))
    if jitter:
        t = t + rng.normal(scale=0.01, size=t.shape)
    return t.astype(np.float32)


def _port_grads(img, theta, pad):
    im = torch.from_numpy(img).requires_grad_(True)
    th = torch.from_numpy(theta).requires_grad_(True)
    torch.sin(warp_mod.two_pass_warp(im, th, pad, False)).sum().backward()
    return im.grad.numpy(), th.grad.numpy()


def _jax_grads(fn, img, theta):
    gi, gt = fn(jnp.asarray(img), jnp.asarray(theta))
    return np.asarray(gi, np.float32), np.asarray(gt, np.float32)


@functools.lru_cache(maxsize=None)
def _grad_fn(kind, pad):
    """The jitted (d_img, d_theta) of sum(sin(warp)), one compile per
    form, padding and shape (interpret mode is slow eagerly)."""
    if kind == "xla":
        warp = lambda im, t: two_pass_affine_warp(  # noqa: E731
            im, t, pad, False, "highest")
    else:
        warp = lambda im, t: pallas_two_pass_warp_trainable(  # noqa: E731
            im, t, pad, False, True)
    return jax.jit(jax.grad(lambda im, t: jnp.sum(jnp.sin(warp(im, t))),
                            argnums=(0, 1)))


def _xla(pad):
    return _grad_fn("xla", pad)


def _pallas(pad):
    return _grad_fn("pallas", pad)


def _assert_close(got, want, what, d_img_atol=1e-4, d_theta_atol=2e-5):
    np.testing.assert_allclose(got[0], want[0], atol=d_img_atol,
                               err_msg=f"d_img {what}")
    scale = float(np.abs(want[1]).max()) + 1e-6
    np.testing.assert_allclose(got[1] / scale, want[1] / scale,
                               atol=d_theta_atol, err_msg=f"d_theta {what}")


@pytest.mark.parametrize("pad", ["zeros", "border"])
@pytest.mark.parametrize("name", sorted(JITTERED))
def test_grads_match_xla_and_pallas(name, pad):
    rng = np.random.default_rng(7)
    img = rng.normal(size=(2, 16, 24, 8)).astype(np.float32)
    theta = _theta(JITTERED[name], 2, rng, jitter=True)
    got = _port_grads(img, theta, pad)
    _assert_close(got, _jax_grads(_xla(pad), img, theta), f"xla {name}/{pad}")
    _assert_close(got, _jax_grads(_pallas(pad), img, theta),
                  f"pallas {name}/{pad}")


@pytest.mark.parametrize("pad", ["zeros", "border"])
@pytest.mark.parametrize("name", sorted(KINKS))
def test_grads_at_exact_kinks(name, pad):
    """At these thetas torch's own autograd through the plain forward
    (abs'(0) = 0, full clamp gradient on the bounds) gives another
    d_theta; the port follows JAX's conventions."""
    rng = np.random.default_rng(8)
    img = rng.normal(size=(1, 16, 24, 8)).astype(np.float32)
    theta = _theta(KINKS[name], 1, rng, jitter=False)
    got = _port_grads(img, theta, pad)
    _assert_close(got, _jax_grads(_xla(pad), img, theta), f"xla {name}/{pad}")
    _assert_close(got, _jax_grads(_pallas(pad), img, theta),
                  f"pallas {name}/{pad}")


def test_grads_where_rounding_reaches_a_fourth_tap():
    """(15, 20) at the identity, zeros padding: the pass-V offset F is
    -3e-8, so g(x, 0) = -3e-8 and g - 1 rounds to exactly -1, a tie one
    tap beyond floor(g) + 1 that the reference counts."""
    rng = np.random.default_rng(13)
    img = rng.normal(size=(3, 15, 20, 16)).astype(np.float32)
    theta = _theta(KINKS["identity"], 3, rng, jitter=False)
    got = _port_grads(img, theta, "zeros")
    _assert_close(got, _jax_grads(_xla("zeros"), img, theta), "xla")
    _assert_close(got, _jax_grads(_pallas("zeros"), img, theta), "pallas")


def test_identity_kink_differs_from_torch_autograd():
    """The reason the backward is written out: at the identity theta,
    autograd through the plain forward misses the kink conventions."""
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.normal(size=(1, 16, 24, 8)).astype(np.float32))
    theta = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
    th = theta.clone().requires_grad_(True)
    out = two_pass_affine_warp_plain_fwd(img, th)[0]
    torch.sin(out).sum().backward()
    _, v = two_pass_affine_warp_plain_fwd(img, theta)
    _, d_theta = two_pass_affine_warp_plain_bwd(
        img, v, theta, torch.cos(out.detach()))
    scale = float(d_theta.abs().max())
    assert float((th.grad - d_theta).abs().max()) > 0.1 * scale


@pytest.mark.parametrize("pad", ["zeros", "border"])
def test_grads_at_collapsed_x_scale(pad):
    """|A| = 4e-4 < 1e-3: each source column takes the gradient of many
    output pixels, and p = D / A_safe is ~1e3 times the other slopes.
    Held against the XLA form, which the port's forward matches there
    (ROADMAP.md Queue 3 notes the Pallas forward differs at |A| < 1e-3)."""
    rng = np.random.default_rng(10)
    img = rng.normal(size=(2, 16, 24, 8)).astype(np.float32)
    theta = _theta(A_TINY, 2, rng, jitter=False)
    got = _port_grads(img, theta, pad)
    _assert_close(got, _jax_grads(_xla(pad), img, theta), f"xla a_tiny/{pad}")


def test_bf16_grads_match_pallas():
    """bf16 features: d_v and d_img stored in bf16 with f32 tent weights
    and f32 sums, as the Pallas backward. d_img at atol 0.02 (about one
    bf16 ulp of values up to ~4, where a bf16 d_v rounds the other way;
    measured 0.0039), d_theta normalised at atol 1e-3 (measured 1.0e-4)."""
    rng = np.random.default_rng(11)
    img = rng.normal(size=(2, 16, 24, 8)).astype(np.float32)
    img_bf = torch.from_numpy(img).to(torch.bfloat16)
    theta = _theta(JITTERED["near_identity"], 2, rng, jitter=True)
    im = img_bf.clone().requires_grad_(True)
    th = torch.from_numpy(theta).requires_grad_(True)
    out = warp_mod.two_pass_warp(im, th)
    assert out.dtype == torch.bfloat16
    torch.sin(out.float()).sum().backward()
    assert im.grad.dtype == torch.bfloat16 and th.grad.dtype == torch.float32

    def loss(i, t):
        o = pallas_two_pass_warp_trainable(i.astype(jnp.bfloat16), t,
                                           "zeros", False, True)
        return jnp.sum(jnp.sin(o.astype(jnp.float32)))

    want = _jax_grads(jax.jit(jax.grad(loss, argnums=(0, 1))),
                      img_bf.float().numpy(), theta)
    _assert_close((im.grad.float().numpy(), th.grad.numpy()), want, "bf16",
                  d_img_atol=0.02, d_theta_atol=1e-3)


def test_function_counts_no_kernel_launch_on_cpu():
    rng = np.random.default_rng(12)
    img = torch.from_numpy(rng.normal(size=(2, 8, 12, 4)).astype(np.float32))
    theta = torch.from_numpy(_theta(JITTERED["zoom"], 2, rng, True))
    warp_mod.launches = warp_mod.bwd_launches = 0
    im = img.clone().requires_grad_(True)
    warp_mod.two_pass_warp(im, theta).sum().backward()
    with torch.inference_mode():
        served = warp_mod.two_pass_warp(img, theta)
    assert not served.requires_grad
    assert warp_mod.launches == warp_mod.bwd_launches == 0
    assert im.grad.shape == img.shape
