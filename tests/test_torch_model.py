"""The port's whole ``GeometryAwareNetwork`` against the JAX package's,
and the weight converters and config copy it is loaded through.

The f32 forward is compared at init_features 8 and 64x64, at B=2 and at
B=1 (where FiLM skips its BN), at atol and rtol 1e-3 on depth in metres.
The bf16 models are compared at atol 0.1 m (1% of max_depth): the two
frameworks round bf16 at different places (fused vs unfused epilogues,
bias added before or after the rounding), and those differences pass
through ~30 convs and a sigmoid.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

from cadepth_tpu import config as jax_config
from cadepth_tpu.geometry.rays import ray_grid_batch as jax_ray_grid_batch
from cadepth_tpu.models import factory as jax_factory
from cadepth_tpu.models.geometry_aware import (
    GeometryAwareNetwork as JaxGeometryAwareNetwork,
)
from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.models import factory
from cadepth_tpu_torch.models.geometry_aware import GeometryAwareNetwork

from torch_port_common import init_random, jax_variables

F, H, W = 8, 64, 64
CONFIGS = sorted((pathlib.Path(__file__).parents[1] / "configs").glob("*.yaml"))


def _batch(b, seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 1, (b, H, W, 3)).astype(np.float32)
    k4 = np.stack([rng.uniform(0.8, 1.2, b) * W, rng.uniform(0.8, 1.2, b) * W,
                   rng.uniform(0.4, 0.6, b) * W, rng.uniform(0.4, 0.6, b) * H],
                  -1).astype(np.float32)
    kmat = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    kmat[:, 0, 0], kmat[:, 1, 1] = k4[:, 0], k4[:, 1]
    kmat[:, 0, 2], kmat[:, 1, 2] = k4[:, 2], k4[:, 3]
    rays = np.array(jax_ray_grid_batch(jnp.asarray(kmat), H, W))
    return rgb, rays, k4


@pytest.fixture(scope="module")
def flagship():
    """JAX flagship variables at f=8, randomized, and the port loaded
    with them."""
    rng = np.random.default_rng(11)
    jm = JaxGeometryAwareNetwork(init_features=F, dtype=jnp.float32)
    params, stats = init_random(jm, rng, *map(jnp.asarray, _batch(2)))
    port = factory.create_model("geometry_aware", init_features=F,
                                dtype=torch.float32, device="cpu")
    port.load_state_dict(convert.to_torch(params, stats))
    return params, stats, port.eval()


@pytest.mark.parametrize("b", [2, 1])
def test_forward_matches_jax_f32(flagship, b):
    params, stats, port = flagship
    rgb, rays, k4 = _batch(b, seed=b)
    jm = JaxGeometryAwareNetwork(init_features=F, dtype=jnp.float32)
    want = np.asarray(jax.jit(jm.apply)(jax_variables(params, stats),
                                        rgb, rays, k4))
    record = {}
    with torch.no_grad():
        got = port(torch.from_numpy(rgb), torch.from_numpy(rays),
                   torch.from_numpy(k4), record).numpy()
    assert got.shape == want.shape == (b, H, W, 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    # five PCLs, each rotating
    assert len(record["pcl_max_rot"]) == 5
    assert min(float(r) for r in record["pcl_max_rot"]) > 0.01


def test_forward_matches_jax_bf16(flagship):
    params, stats, _ = flagship
    rgb, rays, k4 = _batch(2, seed=5)
    jm = JaxGeometryAwareNetwork(init_features=F, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(jm.apply)(jax_variables(params, stats),
                                        rgb, rays, k4))
    port = factory.create_model("geometry_aware", init_features=F,
                                dtype=torch.bfloat16, device="cpu")
    port.load_state_dict(convert.to_torch(params, stats))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(rgb), torch.from_numpy(rays),
                          torch.from_numpy(k4)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.1)


def test_parameters_and_keys_match(flagship):
    params, stats, port = flagship
    assert factory.count_parameters(port) == \
        jax_factory.count_parameters(params)
    assert set(convert.to_torch(params, stats)) == set(port.state_dict())


def test_full_width_parameter_count_matches():
    """At the shipped width (f=64) both packages hold the same number of
    parameters: 129,070,759."""
    jm = JaxGeometryAwareNetwork(init_features=64)
    x = jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32)
    k = jax.ShapeDtypeStruct((1, 4), jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, x, k)
    with torch.device("meta"):
        port = GeometryAwareNetwork(init_features=64)
    n = factory.count_parameters(port)
    assert n == jax_factory.count_parameters(shapes["params"]) == 129_070_759


def test_convert_round_trip_is_exact(flagship):
    params, stats, port = flagship
    back_params, back_stats = convert.to_jax(convert.to_torch(params, stats))
    assert jax.tree_util.tree_structure(back_params) == \
        jax.tree_util.tree_structure(params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back_params, params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back_stats, stats)
    # and from the loaded model's own state_dict
    p2, s2 = convert.to_jax(port.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, p2, params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, s2, stats)


def test_seeded_init_is_reproducible_and_flax_shaped():
    make = lambda seed: factory.create_model(  # noqa: E731
        "geometry_aware", init_features=4, device="cpu",
        generator=torch.Generator().manual_seed(seed))
    a, b, c = make(1), make(1), make(2)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["enc1.conv1.weight"], sc["enc1.conv1.weight"])
    # identity PCL heads, FiLM gamma ~ 1 and beta ~ 0
    torch.testing.assert_close(sa["dec1.pcl.fc_transform.bias"],
                               torch.tensor([1.0, 1, 0, 0, 0, 0]))
    assert not sa["dec1.pcl.fc_transform.weight"].any()
    assert torch.equal(sa["enc1.film.fc_gamma.bias"], torch.ones(4))
    assert sa["enc1.film.fc_gamma.weight"].abs().max() < 0.06
    # lecun-normal: std ~ 1/sqrt(fan_in)
    w = sa["bottleneck.conv.conv1.weight"]
    assert abs(w.std().item() * np.sqrt(w[0].numel()) - 1.0) < 0.05


@pytest.mark.parametrize("experiment", [None, "geometry_aware_full",
                                        "geometry_aware_lightweight"])
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_config_copy_matches(path, experiment):
    raw = yaml.safe_load(path.read_text()) or {}
    if experiment and experiment not in (raw.get("experiments") or {}):
        experiment = None
    want = jax_config.load_config(str(path), experiment)
    got = port_config.load_config(str(path), experiment)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_factory_refuses_what_is_not_ported():
    """Every architecture of the JAX factory is ported: what the port
    refused before builds, and only an unknown name is refused."""
    for arch, variant, cls in (("baseline_unet", "full", "BaselineUNet"),
                               ("geometry_aware", "lightweight",
                                "LightweightGeometryNetwork")):
        model = factory.create_model(arch, init_features=4, variant=variant,
                                     device="cpu")
        assert type(model).__name__ == cls
    with pytest.raises(ValueError, match="Unknown architecture"):
        factory.create_model("resnet", device="cpu")
