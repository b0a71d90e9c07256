"""The port's banded ("fused") warp against the JAX package's.

On the CPU :func:`fused_warp` computes the plain versions, which visit
the same band rows as the CUDA kernels (``test_torch_cuda.py`` and
``chip_smoke.py`` hold the kernels against them on the card). The same
numpy inputs go through ``pallas_fused_warp`` /
``pallas_fused_warp_trainable`` in Pallas interpret mode, as
``test_pallas.py`` runs them.

Tolerances:
- pass V (the banded pass, the new kernel's function) against the
  reference's V: f32 atol 1e-5, bf16 2e-2 (a few bf16 ulps at |x| ~ 4);
- the whole forward against ``pallas_fused_warp``: f32 atol 1e-4, bf16
  2e-2. The reference's pass H in interpret mode builds a dense tent
  matrix whose f32 positions XLA evaluates in its own way: where pass V
  agrees to 2.4e-7, the output differs by up to 2.8e-5 at (2, 48, 64, 8)
  (the bound ``test_torch_warp.py`` holds the two-pass warp's Pallas
  forward to is the same 1e-4);
- gradients of sum(sin(warp)): d_img atol 1e-4, d_theta over its largest
  |entry| atol 2e-5 (the bounds ``test_pallas.py`` holds the Pallas
  backward to), at jittered thetas and at exact kinks.
H = 48 bands for real (kb_f = 12, kb_b = 16 < 48); (4, 14, 20) has it = 2,
the flagship's dec5 tile. The 0.2 rad rotation at 48 x 64 lies outside
the band, where both sides drop the same taps.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadepth_tpu.ops.pallas.fused_warp import (
    _fused_fwd_passes,
    _fused_tiles,
    fused_warp_theta_ok as jax_theta_ok,
    pallas_fused_warp_trainable,
)
from cadepth_tpu_torch.ops import fused_warp as fw

ROT = 0.2
CASES = {
    "identity": [[1, 0, 0], [0, 1, 0.0]],
    "zoom_shift": [[0.8, 0, 0.1], [0, 1.2, -0.2]],
    "rotation": [[0.999, -0.03, 0.02], [0.03, 0.999, 0.01]],
    "shear": [[1.0, 0.1, 0.0], [0.05, 1.0, 0.0]],
    "oob_translate": [[1, 0, 0.9], [0, 1, 0.9]],
    "rot_0.2": [[np.cos(ROT), -np.sin(ROT), 0.0], [np.sin(ROT), np.cos(ROT), 0.0]],
}
SHAPES = [(2, 48, 64, 8), (3, 15, 20, 16), (4, 14, 20, 8)]
# the flagship's five decoder levels and the test shapes
LEVELS = [(14, 20), (30, 40), (60, 80), (120, 160), (240, 320), (48, 64),
          (15, 20), (5, 6), (8, 12), (7, 9)]


def _theta(name, b, rng):
    t = np.tile(np.asarray(CASES[name], np.float32)[None], (b, 1, 1))
    if name not in ("identity", "rot_0.2"):
        t = t + rng.normal(scale=0.01, size=t.shape)
    return t.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_fwd():
    return jax.jit(lambda im, t: _fused_fwd_passes(im, t, "zeros", False,
                                                   True))


@functools.lru_cache(maxsize=None)
def _jax_grad():
    def loss(im, t):
        return jnp.sum(jnp.sin(pallas_fused_warp_trainable(
            im, t, "zeros", False, True).astype(jnp.float32)))
    return jax.jit(jax.grad(loss, argnums=(0, 1)))


@pytest.mark.parametrize("h,w", LEVELS)
def test_tiles_match_jax(h, w):
    assert fw.fused_tiles(h, w) == _fused_tiles(h, w)


def test_theta_ok_matches_jax():
    """The thetas of test_pallas.py's band test, the cases above, and the
    0.2 rad rotation, which is out of band at 48 x 64 and 240 x 320 and
    in band at 60 x 80."""
    rng = np.random.default_rng(0)
    thetas = {
        "mid_zoom": [[1.0, 0, 0], [0, 2.5, 0.0]],
        "big_zoom": [[1.0, 0, 0], [0, 3.5, 0.0]],
        "tiny_zoom": [[1.0, 0, 0], [0, 0.2, 0.0]],
        "big_rot": [[0.96, -0.28, 0], [0.28, 0.96, 0.0]],
        "near_id": [[1.02, -0.02, 0.1], [0.02, 0.97, -0.1]],
    }
    thetas.update({k: _theta(k, 1, rng)[0] for k in CASES})
    batch = np.asarray(list(thetas.values()), np.float32)
    for h, w in [(48, 64), (240, 320), (60, 80), (14, 20), (15, 20)]:
        want = np.asarray(jax_theta_ok(jnp.asarray(batch), h, w))
        got = fw.fused_warp_theta_ok(torch.from_numpy(batch), h, w).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")
    ok = {hw: bool(fw.fused_warp_theta_ok(
        torch.from_numpy(_theta("rot_0.2", 1, rng)), *hw)[0])
        for hw in [(48, 64), (240, 320), (60, 80)]}
    assert ok == {(48, 64): False, (240, 320): False, (60, 80): True}


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax_f32(shape):
    rng = np.random.default_rng(1)
    img = rng.normal(size=shape).astype(np.float32)
    for name in CASES:
        theta = _theta(name, shape[0], rng)
        want_out, want_v = map(np.asarray, _jax_fwd()(img, theta))
        out, v = fw.fused_warp_plain_fwd(torch.from_numpy(img),
                                         torch.from_numpy(theta))
        np.testing.assert_allclose(v.numpy(), want_v, atol=1e-5,
                                   err_msg=f"V {name}")
        with torch.no_grad():
            got = fw.fused_warp(torch.from_numpy(img),
                                torch.from_numpy(theta)).numpy()
        np.testing.assert_array_equal(got, out.numpy())
        np.testing.assert_allclose(got, want_out, atol=1e-4, err_msg=name)


def test_out_of_band_truncates_as_jax_does():
    """0.2 rad at 48 x 64: the banded V pass is far from the two-pass
    one (taps dropped), and the port drops the same taps."""
    from cadepth_tpu_torch.ops.affine_warp import (
        two_pass_affine_warp_plain_fwd,
    )

    rng = np.random.default_rng(2)
    img = rng.normal(size=(2, 48, 64, 8)).astype(np.float32)
    theta = _theta("rot_0.2", 2, rng)
    _, want_v = map(np.asarray, _jax_fwd()(img, theta))
    _, v = fw.fused_warp_plain_fwd(torch.from_numpy(img),
                                   torch.from_numpy(theta))
    _, dense_v = two_pass_affine_warp_plain_fwd(torch.from_numpy(img),
                                                torch.from_numpy(theta))
    assert np.abs(dense_v.numpy() - want_v).max() > 0.5
    np.testing.assert_allclose(v.numpy(), want_v, atol=1e-5)


def test_forward_matches_jax_bf16():
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, 48, 64, 8)).astype(np.float32)
    img_bf = torch.from_numpy(img).to(torch.bfloat16)
    for name in ("rotation", "zoom_shift", "rot_0.2"):
        theta = _theta(name, 2, rng)
        want_out, want_v = _jax_fwd()(
            jnp.asarray(img_bf.float().numpy()).astype(jnp.bfloat16), theta)
        out, v = fw.fused_warp_plain_fwd(img_bf, torch.from_numpy(theta))
        assert out.dtype == v.dtype == torch.bfloat16
        np.testing.assert_allclose(v.float().numpy(),
                                   np.asarray(want_v, np.float32), atol=2e-2,
                                   err_msg=f"V {name}")
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want_out, np.float32),
                                   atol=2e-2, err_msg=name)


def test_border_raises():
    img = torch.zeros(1, 16, 24, 8)
    theta = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0]]])
    for fn in (fw.fused_warp, fw.fused_warp_plain):
        with pytest.raises(ValueError, match="zeros"):
            fn(img, theta, "border")


def _port_grads(img, theta):
    im = torch.from_numpy(img).requires_grad_(True)
    th = torch.from_numpy(theta).requires_grad_(True)
    torch.sin(fw.fused_warp(im, th).float()).sum().backward()
    return im.grad.float().numpy(), th.grad.numpy()


def _assert_grads_close(got, want, what, d_img_atol=1e-4,
                        d_theta_atol=2e-5):
    np.testing.assert_allclose(got[0], np.asarray(want[0], np.float32),
                               atol=d_img_atol, err_msg=f"d_img {what}")
    want_t = np.asarray(want[1], np.float32)
    scale = float(np.abs(want_t).max()) + 1e-6
    np.testing.assert_allclose(got[1] / scale, want_t / scale,
                               atol=d_theta_atol, err_msg=f"d_theta {what}")


@pytest.mark.parametrize("shape", [(2, 48, 64, 8), (4, 14, 20, 8)])
def test_grads_match_jax(shape):
    """Jittered thetas, and exact kinks (identity, an axis zoom, a pure
    vertical shear): every position on the integer grid, where JAX's
    conventions (abs'(0) = +1, half weight at ties) decide d_theta."""
    rng = np.random.default_rng(4)
    img = rng.normal(size=shape).astype(np.float32)
    kinks = {"scale_y": [[1.0, 0.0, 0.0], [0.0, 1.02, 0.0]],
             "shear_d": [[1.0, 0.0, 0.0], [0.01, 1.0, 0.0]]}
    thetas = {k: _theta(k, shape[0], rng)
              for k in ("identity", "zoom_shift", "rotation")}
    thetas.update({k: np.tile(np.asarray(v, np.float32)[None],
                              (shape[0], 1, 1)) for k, v in kinks.items()})
    for name, theta in thetas.items():
        _assert_grads_close(_port_grads(img, theta),
                            _jax_grad()(img, theta), f"{shape} {name}")


def test_bf16_grads_match_jax():
    """bf16 features: the tent weights of both transposed passes rounded
    to bf16, d_v and d_img stored in bf16: d_img at atol 0.02 (one bf16
    ulp of values up to ~4), d_theta normalised at atol 1e-3."""
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.normal(size=(2, 48, 64, 8))
                           .astype(np.float32)).to(torch.bfloat16)
    theta = _theta("rotation", 2, rng)
    im = img.clone().requires_grad_(True)
    th = torch.from_numpy(theta).requires_grad_(True)
    torch.sin(fw.fused_warp(im, th).float()).sum().backward()
    assert im.grad.dtype == torch.bfloat16 and th.grad.dtype == torch.float32
    want = _jax_grad()(jnp.asarray(img.float().numpy()).astype(jnp.bfloat16),
                       theta)
    _assert_grads_close((im.grad.float().numpy(), th.grad.numpy()), want,
                        "bf16", d_img_atol=0.02, d_theta_atol=1e-3)


def test_no_kernel_launch_on_cpu():
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.normal(size=(2, 8, 12, 4)).astype(np.float32))
    theta = torch.from_numpy(_theta("rotation", 2, rng))
    fw.launches = fw.bwd_launches = 0
    im = img.clone().requires_grad_(True)
    fw.fused_warp(im, theta).sum().backward()
    with torch.inference_mode():
        served = fw.fused_warp(img, theta)
    assert not served.requires_grad
    assert fw.launches == fw.bwd_launches == 0
    assert im.grad.shape == img.shape
