"""The flagship's remaining model options in the port against the JAX
package: GroupNorm, the resize upsample, the two camera-aware attention
modules, ``resize_nearest``/``resize_bilinear``, one whole
``GeometryAwareNetwork`` with ``pcl_warp: gather``, ``norm: group`` and
``decoder_upsample: resize``, and remat (port against port).

f32 throughout. Single modules at atol 1e-5 (1e-4 for gradients: f32
sums over a group or a conv window in another order); the whole network
at atol and rtol 1e-3 on depth in metres, the bound of
``tests/test_torch_model.py``. Remat must leave the gradients (1e-6) and
the BN running statistics (exactly) as they are without it.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from cadepth_tpu.geometry.rays import ray_grid_batch as jax_ray_grid_batch
from cadepth_tpu.models import attention as jax_attention
from cadepth_tpu.models import layers as jax_layers
from cadepth_tpu.models.geometry_aware import (
    GeometryAwareNetwork as JaxGeometryAwareNetwork,
)
from cadepth_tpu.ops import resize as jax_resize
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.models import factory
from cadepth_tpu_torch.models.attention import (
    CameraAwareSpatialAttention,
    DepthSpatialAttention,
)
from cadepth_tpu_torch.models.layers import (make_norm, remat_blocks,
                                             upsample2x)
from cadepth_tpu_torch.ops.resize import resize_bilinear, resize_nearest

from torch_port_common import init_random, jax_variables, load_port, nchw, nhwc

F32 = jnp.float32


class _JaxOption(fnn.Module):
    """One JAX helper function (``apply_norm`` or ``upsample2x``) as a
    module, its parameters under the name the models give them."""

    kind: str
    features: int = 0

    @fnn.compact
    def __call__(self, x):
        if self.kind == "group":
            return jax_layers.apply_norm(x, "group", False, "norm", F32)
        return jax_layers.upsample2x(x, self.features, "resize", F32, "up")


class _PortOption(nn.Module):
    def __init__(self, name: str, module: nn.Module):
        super().__init__()
        self.add_module(name, module)
        self.inner = name

    def forward(self, x):
        return getattr(self, self.inner)(x)


@pytest.mark.parametrize("channels,groups", [(12, 12), (48, 24), (64, 32)])
def test_group_norm_matches_flax(channels, groups):
    rng = np.random.default_rng(channels)
    x = (rng.normal(size=(2, 6, 7, channels)) * 3.0 + 1.0).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    jm = _JaxOption("group")
    params, stats = init_random(jm, rng, jnp.asarray(x))
    assert not stats  # GroupNorm keeps no batch statistics

    def run(xx, ct):
        out, vjp = jax.vjp(lambda xi: jm.apply({"params": params}, xi), xx)
        return (out,) + vjp(ct)

    out, want_dx = jax.jit(run)(jnp.asarray(x), jnp.asarray(cot))
    norm = make_norm("group", channels)
    assert isinstance(norm, nn.GroupNorm) and norm.num_groups == groups
    port = load_port(_PortOption("norm", norm), params, {})
    tx = nchw(x).requires_grad_(True)
    got = port(tx)
    got.backward(nchw(cot))
    np.testing.assert_allclose(nhwc(got), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(nhwc(tx.grad), np.asarray(want_dx), atol=1e-4)
    # the converter maps the norm's scale both ways
    back, _ = convert.to_jax(port.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def test_resize_upsample_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    jm = _JaxOption("resize", features=4)
    params, _ = init_random(jm, rng, jnp.asarray(x))
    assert params["up"]["kernel"].shape == (3, 3, 6, 4)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = load_port(_PortOption("up", upsample2x(6, 4, "resize",
                                                  torch.float32)),
                     params, {})
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    assert got.shape == want.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)
    back, _ = convert.to_jax(port.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def test_depth_spatial_attention_matches():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 13, 17, 8)).astype(np.float32)
    jm = jax_attention.DepthSpatialAttention(8, dtype=F32)
    params, _ = init_random(jm, rng, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = load_port(DepthSpatialAttention(8, dtype=torch.float32), params, {})
    with torch.no_grad():
        got = nhwc(port(nchw(x)))
    assert got.shape == want.shape == (2, 13, 17, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_camera_aware_spatial_attention_matches():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, 9, 8)).astype(np.float32)
    cam = rng.normal(0.0, 0.5, (2, 4)).astype(np.float32)
    jm = jax_attention.CameraAwareSpatialAttention(8, dtype=F32)
    params, _ = init_random(jm, rng, jnp.asarray(x), jnp.asarray(cam))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(cam)))
    port = load_port(CameraAwareSpatialAttention(8, dtype=torch.float32),
                     params, {})
    with torch.no_grad():
        got = nhwc(port(nchw(x), torch.from_numpy(cam)))
    assert got.shape == want.shape == (2, 11, 9, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("size", [(24, 40), (7, 5), (13, 13)])
def test_resizes_match(size):
    rng = np.random.default_rng(sum(size))
    x = rng.normal(size=(2, 3, 13, 13, 4)).astype(np.float32)
    for lead in (x, x[0]):
        want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(lead), *size))
        got = resize_bilinear(torch.from_numpy(lead), *size).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_array_equal(
            resize_nearest(torch.from_numpy(lead), *size).numpy(),
            np.asarray(jax_resize.resize_nearest(jnp.asarray(lead), *size)))
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    assert resize_bilinear(x16, *size).dtype == torch.bfloat16


OPTIONS = dict(pcl_warp="gather", norm="group", decoder_upsample="resize")
F, H, W = 4, 32, 32


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 1, (b, H, W, 3)).astype(np.float32)
    k4 = np.stack([rng.uniform(0.6, 1.4, b) * W, rng.uniform(0.6, 1.4, b) * W,
                   rng.uniform(0.3, 0.7, b) * W, rng.uniform(0.3, 0.7, b) * H],
                  -1).astype(np.float32)
    kmat = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    kmat[:, 0, 0], kmat[:, 1, 1] = k4[:, 0], k4[:, 1]
    kmat[:, 0, 2], kmat[:, 1, 2] = k4[:, 2], k4[:, 3]
    rays = np.array(jax_ray_grid_batch(jnp.asarray(kmat), H, W))
    return rgb, rays, k4


def test_network_with_the_options_matches_jax():
    """gather PCLs, GroupNorm blocks, resize upsampling, eval mode."""
    rgb, rays, k4 = _batch(2, seed=4)
    jm = JaxGeometryAwareNetwork(init_features=F, dtype=F32, **OPTIONS)
    params, stats = init_random(jm, np.random.default_rng(5), rgb, rays, k4)
    # GroupNorm in every block: FiLM's BatchNorm1d keeps the only statistics
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(stats)]
    assert paths and all("'film'" in p for p in paths)
    record = {}
    port = factory.create_model("geometry_aware", init_features=F,
                                dtype=torch.float32, device="cpu", **OPTIONS)
    port.load_state_dict(convert.to_torch(params, stats))
    want, inter = jax.jit(lambda v, *a: jm.apply(
        v, *a, mutable=["intermediates"]))(jax_variables(params, stats),
                                            rgb, rays, k4)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(rgb), torch.from_numpy(rays),
                          torch.from_numpy(k4), record).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3, rtol=1e-3)
    rots = [float(r) for r in record["pcl_max_rot"]]
    want_rots = [float(r) for r in jax.tree_util.tree_leaves(inter)]
    np.testing.assert_allclose(sorted(rots), sorted(want_rots), rtol=1e-5)
    assert min(rots) > 0.01


def _train_step_grads(remat, batch):
    """One train-mode forward and backward of the f=4 flagship (BN,
    two-pass PCLs) with ``remat``: (grads, BN statistics, depth,
    pcl_max_rot entries)."""
    model = factory.create_model(
        "geometry_aware", init_features=F, dtype=torch.float32, device="cpu",
        remat=remat, generator=torch.Generator().manual_seed(6)).train()
    record = {}
    depth = model(*batch, record)
    (depth * depth).mean().backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k or "num_batches" in k}
    return grads, stats, depth.detach(), len(record["pcl_max_rot"])


@pytest.fixture(scope="module")
def no_remat():
    batch = tuple(torch.from_numpy(a) for a in _batch(4, seed=7))
    return batch, _train_step_grads(False, batch)


@pytest.mark.parametrize("remat", ["full", "highres"])
def test_remat_keeps_gradients_and_statistics(no_remat, remat):
    batch, (grads, stats, depth, n_rot) = no_remat
    got_grads, got_stats, got_depth, got_rot = _train_step_grads(remat, batch)
    torch.testing.assert_close(got_depth, depth, rtol=0, atol=0)
    assert got_grads.keys() == grads.keys()
    for k, g in got_grads.items():
        torch.testing.assert_close(g, grads[k], rtol=0, atol=1e-6, msg=k)
    # the recompute leaves the running statistics and the counts alone
    assert got_stats.keys() == stats.keys()
    for k, s in got_stats.items():
        torch.testing.assert_close(s, stats[k], rtol=0, atol=0, msg=k)
    assert int(got_stats["enc1.bn1.num_batches_tracked"]) == 1
    assert got_rot == n_rot == 5


def test_remat_selects_the_blocks_of_maybe_remat():
    """True and "full" checkpoint every block, "highres" the blocks at
    the two finest levels (the JAX blocks built with highres_block=True)."""
    every = set(remat_blocks("full"))
    assert set(remat_blocks(True)) == every and len(every) == 11
    assert set(remat_blocks("highres")) == {"enc1", "enc2", "dec2", "dec1"}
    assert remat_blocks(False) == remat_blocks(None) == ()


def test_remat_refuses_unknown_modes():
    with pytest.raises(ValueError, match="remat"):
        factory.create_model("geometry_aware", init_features=F, device="cpu",
                             remat="sometimes")
