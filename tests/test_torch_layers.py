"""Each module of the port's serving path against its JAX counterpart,
in eval mode and f32, from the same converted variables.

Batch statistics are random (mean ~ N(0, 0.1), var ~ U(0.5, 2)) and the
PCL heads rotate and shear, so BN and the warp do real work. Tolerances
are f32 round-off through at most two convs: atol 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cadepth_tpu.geometry.intrinsics import normalize_k4 as jax_normalize_k4
from cadepth_tpu.geometry.rays import ray_grid_batch as jax_ray_grid_batch
from cadepth_tpu.models import attention as jax_attention
from cadepth_tpu.models import film as jax_film
from cadepth_tpu.models import geometry_aware as jax_ga
from cadepth_tpu.models import pcl as jax_pcl
from cadepth_tpu.ops import resize as jax_resize
from cadepth_tpu_torch.geometry.intrinsics import (
    k4_from_matrix,
    matrix_from_k4,
    normalize_k4,
)
from cadepth_tpu_torch.geometry.rays import ray_grid, ray_grid_batch
from cadepth_tpu_torch.models.attention import CBAM
from cadepth_tpu_torch.models.film import FiLMLayer
from cadepth_tpu_torch.models.geometry_aware import (
    GeometryDecoderBlock,
    GeometryEncoderBlock,
    RayEnhancedConv,
)
from cadepth_tpu_torch.models.pcl import (
    PerspectiveCorrectionLayer,
    _build_affine_matrix,
)
from cadepth_tpu_torch.ops.resize import avg_pool2d, max_pool2d

from torch_port_common import init_random, jax_variables, load_port, nchw, nhwc

F32 = jnp.float32
ATOL = 1e-4
WARP_MODES = ["two_pass", "pallas", "fused", "gather", "auto", "separable"]


def _k4(rng, b, h, w):
    return np.stack([rng.uniform(0.8, 1.2, b) * w, rng.uniform(0.8, 1.2, b) * w,
                     rng.uniform(0.4, 0.6, b) * w, rng.uniform(0.4, 0.6, b) * h],
                    -1).astype(np.float32)


def _cam(rng, b):
    return rng.normal(0.0, 0.5, (b, 4)).astype(np.float32)


def test_intrinsics_and_rays_match():
    rng = np.random.default_rng(0)
    k4 = _k4(rng, 3, 24, 40)
    np.testing.assert_allclose(
        normalize_k4(torch.from_numpy(k4), width=40, height=24).numpy(),
        np.asarray(jax_normalize_k4(jnp.asarray(k4), width=40, height=24)),
        rtol=1e-7, atol=0)
    kmat = matrix_from_k4(torch.from_numpy(k4))
    np.testing.assert_array_equal(k4_from_matrix(kmat).numpy(), k4)
    got = ray_grid_batch(kmat, 24, 40).numpy()
    want = np.asarray(jax_ray_grid_batch(jnp.asarray(kmat.numpy()), 24, 40))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(ray_grid(kmat[1], 24, 40).numpy(), got[1])


@pytest.mark.parametrize("factor", [1, 2, 3, 16])
def test_pooling_matches(factor):
    x = np.random.default_rng(factor).normal(size=(2, 35, 50, 3)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        avg_pool2d(torch.from_numpy(x), factor).numpy(),
        np.asarray(jax_resize.avg_pool2d(jnp.asarray(x), factor)), atol=1e-6)
    np.testing.assert_array_equal(
        max_pool2d(torch.from_numpy(x), factor).numpy(),
        np.asarray(jax_resize.max_pool2d(jnp.asarray(x), factor)))


def test_film_matches_at_one_and_two_images():
    """The JAX FiLM skips its BN at B=1, so an image alone gets another
    answer than in a batch; the port reproduces both."""
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(2, 6, 7, 16)).astype(np.float32)
    cam = _cam(rng, 2)
    jm = jax_film.FiLMLayer(16, dtype=F32)
    params, stats = init_random(jm, rng, jnp.asarray(feats), jnp.asarray(cam))
    port = load_port(FiLMLayer(16), params, stats)
    outs = {}
    for b in (1, 2):
        want = np.asarray(jm.apply(jax_variables(params, stats),
                                   jnp.asarray(feats[:b]), jnp.asarray(cam[:b])))
        with torch.no_grad():
            got = nhwc(port(nchw(feats[:b]), torch.from_numpy(cam[:b])))
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=f"B={b}")
        outs[b] = got
    assert np.abs(outs[1][0] - outs[2][0]).max() > 1e-3


@pytest.mark.parametrize("lowering", ["toeplitz", "stencil", "conv"])
def test_cbam_matches_every_jax_lowering(lowering):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 13, 32)).astype(np.float32)
    jm = jax_attention.CBAM(32, dtype=F32, sa_lowering=lowering)
    params, _ = init_random(jm, rng, jnp.asarray(x))
    port = load_port(CBAM(32, dtype=torch.float32, sa_lowering=lowering),
                     params, {})
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_build_affine_matrix_matches():
    p = np.random.default_rng(3).normal(size=(4, 6)).astype(np.float32)
    np.testing.assert_allclose(
        _build_affine_matrix(torch.from_numpy(p)).numpy(),
        np.asarray(jax_pcl._build_affine_matrix(jnp.asarray(p))), atol=1e-7)


@pytest.mark.parametrize("warp_mode", WARP_MODES)
def test_pcl_matches(warp_mode):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 14, 20, 16)).astype(np.float32)
    cam = _cam(rng, 2)
    jm = jax_pcl.PerspectiveCorrectionLayer(16, warp_mode=warp_mode,
                                            dtype=F32)
    params, _ = init_random(jm, rng, jnp.asarray(x), jnp.asarray(cam))
    want, inter = jm.apply({"params": params}, jnp.asarray(x),
                           jnp.asarray(cam), mutable=["intermediates"])
    port = load_port(PerspectiveCorrectionLayer(16, warp_mode=warp_mode),
                     params, {})
    record = {}
    with torch.no_grad():
        got = nhwc(port(nchw(x), torch.from_numpy(cam), record))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    rot = float(inter["intermediates"]["pcl_max_rot"][0])
    assert rot > 0.01  # the head really rotates
    np.testing.assert_allclose(float(record["pcl_max_rot"][0]), rot, rtol=1e-5)
    # the warp really moved the features
    assert np.abs(got - x).max() > 0.1


@pytest.mark.parametrize("with_rays", [True, False])
def test_ray_enhanced_conv_matches(with_rays):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, 16, 5)).astype(np.float32)
    rays = rng.normal(size=(2, 12, 16, 3)).astype(np.float32)
    cam = _cam(rng, 2)
    jm = jax_ga.RayEnhancedConv(8, dtype=F32)
    jrays = jnp.asarray(rays) if with_rays else None
    params, stats = init_random(jm, rng, jnp.asarray(x), jnp.asarray(cam),
                                jrays)
    want = np.asarray(jm.apply(jax_variables(params, stats), jnp.asarray(x),
                               jnp.asarray(cam), jrays))
    port = load_port(RayEnhancedConv(5 + 3 * with_rays, 8,
                                     dtype=torch.float32), params, stats)
    with torch.no_grad():
        got = nhwc(port(nchw(x), torch.from_numpy(cam),
                        nchw(rays) if with_rays else None))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_encoder_block_matches():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 17, 22, 8)).astype(np.float32)  # odd: floor pool
    cam = _cam(rng, 2)
    jm = jax_ga.GeometryEncoderBlock(16, dtype=F32)
    params, stats = init_random(jm, rng, jnp.asarray(x), jnp.asarray(cam))
    want = np.asarray(jm.apply(jax_variables(params, stats), jnp.asarray(x),
                               jnp.asarray(cam)))
    port = load_port(GeometryEncoderBlock(8, 16, dtype=torch.float32),
                     params, stats)
    with torch.no_grad():
        got = nhwc(port(nchw(x), torch.from_numpy(cam)))
    assert got.shape == want.shape == (2, 8, 11, 16)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("warp_mode", WARP_MODES)
def test_decoder_block_matches(warp_mode):
    """Upsample -> PCL -> pad to an odd skip -> [skip, x] -> conv -> CBAM."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 7, 10, 16)).astype(np.float32)
    skip = rng.normal(size=(2, 15, 21, 8)).astype(np.float32)
    cam = _cam(rng, 2)
    rays = rng.normal(size=(2, 15, 21, 3)).astype(np.float32)
    jm = jax_ga.GeometryDecoderBlock(8, pcl_warp=warp_mode, dtype=F32)
    args = (jnp.asarray(x), jnp.asarray(skip), jnp.asarray(cam),
            jnp.asarray(rays))
    params, stats = init_random(jm, rng, *args)
    want = np.asarray(jm.apply(jax_variables(params, stats), *args))
    port = load_port(GeometryDecoderBlock(16, 8, pcl_warp=warp_mode,
                                          dtype=torch.float32), params, stats)
    with torch.no_grad():
        got = nhwc(port(nchw(x), nchw(skip), torch.from_numpy(cam)))
    assert got.shape == want.shape == (2, 15, 21, 8)
    np.testing.assert_allclose(got, want, atol=ATOL)
