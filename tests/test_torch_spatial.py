"""Spatial parallelism's pieces in the port (``parallel.make_mesh_2d``,
``parallel.spatial``) against JAX's mesh and against the same operation
on the whole tensor; the windowed two-pass warp against JAX's.

- The rank grid of ``make_mesh_2d`` is JAX's ``make_mesh_2d(8,
  spatial=4).devices``, and each rank's part of a batch is the index of
  its device's shard under JAX's ``batch_shardings`` (device_put only,
  no compile).
- On two Gloo ranks (each a process of ``tests/_torch_spatial_worker.py``
  on 127.0.0.1), each collective (the halo rows of 1, 3 and 6 rows,
  the last past a neighbour's 4-row band; the gather, the band of a whole
  map, the sum, the maximum with a tie across the bands, the mean over H
  and W) and each layer that crosses bands (a 3x3 conv, the spatial
  gate's 7x7, the edge 3x3 and the dilation-2 7x7 of the depth gate, a
  group norm, the channel gate, a PCL whose two-pass warp runs on a
  window of rows) against the same function of the whole tensor: every
  rank's output its part of the whole one, the bands' input gradients
  the whole input's, and the parameter gradients summed over the ranks
  the whole one's, within 1e-6 times max(1, the largest entry) (f32).
- The lightweight network, ``IntrinsicsAttentionUNet`` and the flagship
  with ``norm: group`` and ``decoder_upsample: resize`` (at 48x64, with
  its tail whole): one training-mode forward on two bands against one
  process.
- The windowed plain warp (what a CPU tensor takes) against the rows of
  JAX's XLA ``two_pass_affine_warp`` within 1e-5 (slice 1's bound), and
  its backward windows summed over a partition of H against the whole
  backward (d_img within f32 order, d_theta within 1e-4 of its largest
  entry).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_port_common  # noqa: F401  (one torch thread per process)
from _torch_spatial_worker import forward_case, launch
from cadepth_tpu.ops.affine_warp import two_pass_affine_warp
from cadepth_tpu.parallel import batch_shardings as jax_batch_shardings
from cadepth_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch.models.attention import (ChannelAttention,
                                                DepthSpatialAttention,
                                                SpatialAttention)
from cadepth_tpu_torch.models.layers import Conv2d, GroupNorm
from cadepth_tpu_torch.models.pcl import PerspectiveCorrectionLayer
from cadepth_tpu_torch.ops import two_pass_warp as tpw
from cadepth_tpu_torch.ops.affine_warp import (
    two_pass_affine_warp_plain_bwd, two_pass_affine_warp_plain_fwd)
from cadepth_tpu_torch.parallel import (DataParallel, SpaceGroup,
                                        batch_shardings, image_sharding,
                                        shard_batch)
from cadepth_tpu_torch.parallel.mesh import space_grid
from cadepth_tpu_torch.training import train_state as ts
from torch_port_common import PCL_BIAS, make_train_batch, torch_batch

RANKS = 2
C, H, W = 6, 8, 10           # bands of 4 rows
HALO_ROWS = (1, 3, 6)


def mesh_of(world: int, spatial: int, rank: int) -> DataParallel:
    """A rank's place in a data x space group, without a process group."""
    return DataParallel(world, rank, space=SpaceGroup(spatial,
                                                      rank % spatial))


def test_rank_grid_is_jax_device_grid():
    mesh = jax_make_mesh_2d(8, spatial=4)
    assert mesh.axis_names == ("data", "space")
    ids = [[d.id for d in row] for row in mesh.devices]
    assert space_grid(8, 4) == ids
    for rank in range(8):
        dp = mesh_of(8, 4, rank)
        assert (dp.data_rank, dp.space.rank) == divmod(rank, 4)
        assert dp.data_size == 2
    with pytest.raises(ValueError, match="not divisible by spatial"):
        space_grid(6, 4)


def test_parts_are_jax_shards():
    """Each rank's rows and band of every key of a global batch are the
    index of its device's shard under JAX's batch_shardings."""
    mesh = jax_make_mesh_2d(8, spatial=4)
    batch = make_train_batch(np.random.default_rng(0), 4, 16, 8)
    table = jax_batch_shardings(mesh)
    for key, value in batch.items():
        arr = jax.device_put(jnp.asarray(value), table[key])
        for shard in arr.addressable_shards:
            dp = mesh_of(8, 4, shard.device.id)
            got = shard_batch({key: torch.from_numpy(value)}, dp)[key]
            np.testing.assert_array_equal(got.numpy(), value[shard.index],
                                          err_msg=f"{key} {shard.device}")
            part = batch_shardings(dp)[key](torch.from_numpy(value))
            assert torch.equal(part, got)
    x = torch.arange(4 * 16 * 8 * 3.0).reshape(4, 16, 8, 3)
    assert torch.equal(image_sharding(mesh_of(8, 4, 6))(x), x[2:, 8:12])
    with pytest.raises(ValueError, match="not divisible by 4 bands"):
        image_sharding(mesh_of(8, 4, 0))(x[:, :6])


def modules(seed: int):
    """The layers of the ops case, drawn from ``seed``."""
    torch.manual_seed(seed)
    out = {"conv3x3": Conv2d(C, 5, 3, padding=1, dtype=torch.float32),
           "gate7x7": SpatialAttention(7, torch.float32),
           "dilated": DepthSpatialAttention(C, 7, torch.float32),
           "group_norm": GroupNorm(2, C, eps=1e-6),
           "channel_gate": ChannelAttention(C, 2, torch.float32)}
    with torch.no_grad():
        out["group_norm"].weight.uniform_(0.5, 1.5)
        out["group_norm"].bias.uniform_(-0.5, 0.5)
    pcl = PerspectiveCorrectionLayer(C)
    with torch.no_grad():
        pcl.fc_transform.weight.normal_(0.0, 0.002)
        pcl.fc_transform.bias.copy_(torch.from_numpy(PCL_BIAS))
    out["pcl"] = pcl
    return out


def band(x: torch.Tensor, r: int, dim: int = 2) -> torch.Tensor:
    h = x.shape[dim] // RANKS
    return x.narrow(dim, r * h, h)


# what each rank's output is, as a function of the whole input
OPS = {
    **{f"halo_{p}": (lambda x, r, p=p: F.pad(x, (0, 0, p, p))[
        :, :, r * (H // RANKS):r * (H // RANKS) + H // RANKS + 2 * p])
       for p in HALO_ROWS},
    "gather": lambda x, r: x,
    "band": lambda x, r: band(x * 2.0, r),
    "sum": lambda x, r: (x * x).sum(dim=(2, 3)),
    "amax": lambda x, r: x.amax(dim=(2, 3)),
    "mean_hw": lambda x, r: x.mean(dim=(2, 3)),
}
BANDED_MODULES = ("conv3x3", "gate7x7", "dilated", "group_norm")


@pytest.fixture(scope="module")
def ops_runs(tmp_path_factory):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, C, H, W)).astype(np.float32))
    # a maximum tied across the two bands in one channel
    x[0, 1, 1, 2] = x[0, 1, 6, 3] = 9.0
    x = x.contiguous(memory_format=torch.channels_last)
    mods = modules(4)
    k4 = torch.from_numpy(rng.uniform(0.3, 1.2, (2, 4)).astype(np.float32))
    setup = {"ops": {
        "kind": "ops", "spatial": 2, "x": x, "halo_rows": HALO_ROWS,
        "cots": [torch.from_numpy(rng.normal(size=4 * x.numel())
                                  .astype(np.float32)) for _ in range(RANKS)],
        "modules": {k: m.state_dict() for k, m in mods.items()},
        "k4": k4,
        "pcl_cot": torch.from_numpy(rng.normal(size=(2, C, H, W))
                                    .astype(np.float32))}}
    forwards = {}
    for name, model, h, seed in (
            ("lightweight", {"architecture": "geometry_aware",
                             "variant": "lightweight"}, 64, 5),
            ("intrinsics_attention", {"architecture": "intrinsics_unet",
                                      "use_attention": True}, 64, 6),
            ("group_resize", {"architecture": "geometry_aware",
                              "norm": "group",
                              "decoder_upsample": "resize"}, 48, 7)):
        raw = {"model": {"init_features": 4, **model},
               "data": {"input_height": h, "input_width": 64},
               "training": {"use_amp": False, "batch_size": 4}}
        cfg = port_config.config_from_dict(raw)
        m, _ = ts.build_model_and_loss(
            cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
        forwards[name] = {
            "kind": "forward", "spatial": 2, "raw": raw,
            "state": m.state_dict(),
            "batch": torch_batch(make_train_batch(
                np.random.default_rng(seed), 4, h, 64))}
    setup.update(forwards)
    work = tmp_path_factory.mktemp("torch_spatial")
    torch.save(setup, work / "setup.pt")
    return setup, mods, launch(work, RANKS)


def whole(name: str, fn, setup, mods):
    """Each rank's output, the whole input's gradient and the parameters'
    of sum over the ranks of <rank's output, rank's cotangent>, computed
    on the whole tensor."""
    case = setup["ops"]
    x = case["x"].clone().requires_grad_()
    outs, total = [], 0.0
    for r in range(RANKS):
        out = fn(x, r)
        outs.append(out.detach())
        if name == "pcl":
            cot = band(case["pcl_cot"], r)
        else:
            cot = case["cots"][r][:out.numel()].reshape(out.shape)
        total = total + (out * cot).sum()
    m = mods.get(name)
    params = [] if m is None else list(m.parameters())
    grads = torch.autograd.grad(total, [x] + params)
    names = [] if m is None else [k for k, _ in m.named_parameters()]
    return outs, grads[0], dict(zip(names, grads[1:]))


def assert_near(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Within 1e-6 of ``want``, scaled by its largest entry where that is
    above 1 (an f32 sum of the band's terms runs in another order)."""
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    assert got.shape == want.shape and err <= 1e-6 * scale, \
        f"{what}: max |diff| {err:.3g}, largest entry {scale:.3g}"


def check(name: str, fn, ops_runs):
    setup, mods, outs = ops_runs
    want_out, want_dx, want_grads = whole(name, fn, setup, mods)
    for r in range(RANKS):
        got = outs[r]["ops"][name]
        assert_near(got["out"], want_out[r], f"{name} rank {r} out")
        assert_near(got["dx"], band(want_dx, r), f"{name} rank {r} dx")
    for k, w in want_grads.items():
        got = sum(outs[r]["ops"][name]["grads"][k] for r in range(RANKS))
        assert_near(got, w, f"{name} {k}")


@pytest.mark.parametrize("name", list(OPS))
def test_collectives_match_the_whole_tensor(ops_runs, name):
    check(name, OPS[name], ops_runs)


@pytest.mark.parametrize("name", BANDED_MODULES + ("channel_gate", "pcl"))
def test_layers_on_bands_match_the_whole_map(ops_runs, name):
    mods = ops_runs[1]
    m = mods[name]
    if name == "pcl":
        k4 = ops_runs[0]["ops"]["k4"]

        def fn(x, r):
            return band(m(x, k4), r)
    elif name == "channel_gate":
        def fn(x, r):
            return m(x)
    else:
        def fn(x, r):
            return band(m(x), r)
    check(name, fn, ops_runs)


@pytest.mark.parametrize("name", ["lightweight", "intrinsics_attention",
                                  "group_resize"])
def test_family_forward_on_bands(ops_runs, name):
    setup, _, outs = ops_runs
    want = forward_case(setup[name], None)
    for r in range(RANKS):
        torch.testing.assert_close(outs[r][name], band(want, r, 1),
                                   rtol=1e-5, atol=1e-5, msg=f"rank {r}")


WINDOW_THETAS = {
    "zoom_shift": [[0.8, 0, 0.1], [0, 1.2, -0.2]],
    "rotation": [[0.999, -0.03, 0.02], [0.03, 0.999, 0.01]],
    "shear": [[1.0, 0.1, 0.0], [0.05, 1.0, 0.0]],
}
# a partition of 24 rows into windows
WINDOWS = ((0, 5), (5, 7), (12, 12))


@pytest.mark.parametrize("name", list(WINDOW_THETAS))
@pytest.mark.parametrize("pad", ["zeros", "border"])
def test_windowed_warp_is_rows_of_jax_warp(name, pad):
    rng = np.random.default_rng(11)
    img = rng.normal(size=(2, 24, 20, 8)).astype(np.float32)
    theta = (np.asarray(WINDOW_THETAS[name], np.float32)[None]
             + rng.normal(scale=0.01, size=(2, 2, 3))).astype(np.float32)
    want = np.asarray(two_pass_affine_warp(jnp.asarray(img),
                                           jnp.asarray(theta), pad, False,
                                           "highest"))
    img_t, theta_t = torch.from_numpy(img), torch.from_numpy(theta)
    whole_out, v = two_pass_affine_warp_plain_fwd(img_t, theta_t, pad)
    cot = torch.from_numpy(rng.normal(size=whole_out.shape)
                           .astype(np.float32))
    d_img, d_theta = two_pass_affine_warp_plain_bwd(img_t, v, theta_t, cot,
                                                    pad)
    sum_img, sum_theta = torch.zeros_like(d_img), torch.zeros_like(d_theta)
    for row0, rows in WINDOWS:
        out = tpw.two_pass_warp(img_t, theta_t, pad, False, row0, rows)
        np.testing.assert_allclose(out.numpy(), want[:, row0:row0 + rows],
                                   atol=1e-5)
        assert torch.equal(out, whole_out[:, row0:row0 + rows])
        w_out, w_v = two_pass_affine_warp_plain_fwd(img_t, theta_t, pad,
                                                    False, row0, rows)
        assert torch.equal(w_v, v[:, row0:row0 + rows])
        a, b = two_pass_affine_warp_plain_bwd(
            img_t, w_v, theta_t, cot[:, row0:row0 + rows].contiguous(), pad,
            False, row0, rows)
        sum_img += a
        sum_theta += b
    torch.testing.assert_close(sum_img, d_img, rtol=1e-6, atol=1e-6)
    assert float((sum_theta - d_theta).abs().max()) <= \
        1e-4 * float(d_theta.abs().max())


def test_window_autograd_and_refusals():
    """The autograd Function over a window gives the window's backward;
    a window outside the map raises."""
    rng = np.random.default_rng(12)
    img = torch.from_numpy(rng.normal(size=(2, 12, 10, 4)).astype(np.float32))
    theta = torch.from_numpy(np.asarray(WINDOW_THETAS["rotation"],
                                        np.float32)[None].repeat(2, 0))
    x, t = img.clone().requires_grad_(), theta.clone().requires_grad_()
    out = tpw.two_pass_warp(x, t, "zeros", False, 4, 6)
    assert out.shape == (2, 6, 10, 4)
    cot = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    out.backward(cot)
    _, v = two_pass_affine_warp_plain_fwd(img, theta, "zeros", False, 4, 6)
    d_img, d_theta = two_pass_affine_warp_plain_bwd(img, v, theta, cot,
                                                    "zeros", False, 4, 6)
    assert torch.equal(x.grad, d_img) and torch.equal(t.grad, d_theta)
    with torch.no_grad():
        served = tpw.two_pass_warp(img, theta, "zeros", False, 4, 6)
    assert torch.equal(served, out.detach())
    for row0, rows in ((10, 3), (-1, 2)):
        with pytest.raises(ValueError, match="outside the map"):
            tpw.two_pass_warp(img, theta, "zeros", False, row0, rows)
