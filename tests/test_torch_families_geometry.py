"""The port's ``IntrinsicsAttentionUNet`` and
``LightweightGeometryNetwork`` against the JAX package's (f=8, f32, the
checks of ``test_torch_families.py``), the lightweight network's
``pcl_max_rot`` against the intermediates JAX sows, and
``create_model``'s dispatch against JAX's table; and why the gradients
are held against JAX's float64 gradient.

The lightweight network's PCL heads are drawn off zero (a small random
kernel and a rotating, zooming bias, ``torch_port_common.randomize``), so
all four warps move the features; on the CPU the port's warp is the
two-pass plain version, JAX's the XLA two-pass form.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadepth_tpu.models import factory as jax_factory
from cadepth_tpu_torch.models import factory

from torch_port_common import (assert_grads_close, assert_round_trip_exact,
                               build_family, family_args, family_forward,
                               family_grads, family_raw, full_width_counts,
                               jax_variables, leaves, make_train_batch)

FAMILIES = {
    "intrinsics_attention_unet": dict(model={}, cls="IntrinsicsAttentionUNet",
                                      tol=2e-2),
    "geometry_aware_lightweight": dict(model={},
                                       cls="LightweightGeometryNetwork",
                                       tol=2e-2),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    arch = request.param
    return arch, build_family(family_raw(arch, **FAMILIES[arch]["model"]),
                              seed=22)


@pytest.mark.parametrize("b", [4, 1])
def test_forward_matches_jax_f32(family, b):
    arch, fam = family
    assert type(fam[1][1]).__name__ == FAMILIES[arch]["cls"]
    got, want, record = family_forward(fam, b, seed=b)
    assert got.shape == want.shape == (b, 64, 64, 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    if arch == "geometry_aware_lightweight":
        # four PCLs, each rotating
        assert len(record["pcl_max_rot"]) == 4
        assert min(float(r) for r in record["pcl_max_rot"]) > 0.01
    else:
        assert record == {}


def test_forward_matches_jax_bf16(family):
    _, fam = family
    got, want, _ = family_forward(fam, 2, seed=5, use_amp=True)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.1)


def test_gradients_match_jax(family):
    arch, fam = family
    rng = np.random.default_rng(6)
    batch = make_train_batch(rng, 8, 32, 32)
    mask = rng.uniform(size=(8, 32, 32, 1)).astype(np.float32)
    got, want = family_grads(fam, batch, mask)
    assert_grads_close(got, want, FAMILIES[arch]["tol"])


def test_parameter_counts_match(family):
    arch, fam = family
    (_, _, _), (_, model, _), (params, _) = fam
    assert factory.count_parameters(model) == \
        jax_factory.count_parameters(params)
    port, jax_count = full_width_counts(arch, **FAMILIES[arch]["model"])
    assert port == jax_count


def test_convert_round_trip_is_exact(family):
    assert_round_trip_exact(family[1])


def test_lightweight_pcl_max_rot_matches_jax_intermediates():
    arch = "geometry_aware_lightweight"
    (_, jm, _), (_, model, _), (params, stats) = build_family(
        family_raw(arch), seed=23)
    ja, pa = family_args(arch, make_train_batch(np.random.default_rng(7)))
    _, inter = jax.jit(lambda v, *a: jm.apply(v, *a, mutable=[
        "intermediates"]))(jax_variables(params, stats), *ja)
    want = [float(inter["intermediates"][f"dec{i}"]["pcl"]["pcl_max_rot"][0])
            for i in (4, 3, 2, 1)]
    record = {}
    with torch.no_grad():
        model(*pa, record)
    got = [float(r) for r in record["pcl_max_rot"]]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert min(got) > 0.01


# (architecture, use_attention, variant) of JAX's dispatch table (the
# port's families that the JAX package has)
DISPATCH = [(arch, att, var)
            for arch in jax_factory.ARCHITECTURES
            for att in (True, False) for var in ("full", "lightweight")]


@pytest.mark.parametrize("arch,use_attention,variant", DISPATCH)
def test_dispatch_matches_jax(arch, use_attention, variant):
    jm = jax_factory.create_model(arch, init_features=64,
                                  use_attention=use_attention,
                                  variant=variant, dtype=jnp.float32)
    with torch.device("meta"):
        port = factory.create_model(arch, init_features=64,
                                    use_attention=use_attention,
                                    variant=variant, dtype=torch.float32,
                                    device="meta")
    assert type(port).__name__ == type(jm).__name__
    assert port.dtype == torch.float32
    # the lightweight network caps init_features at 32, as JAX's does
    assert port.out_conv.in_channels == jm.init_features
    assert jm.init_features == (32 if "Lightweight" in type(jm).__name__
                                else 64)


def test_unknown_architecture_is_refused():
    with pytest.raises(ValueError, match="Unknown architecture"):
        factory.create_model("resnet", device="cpu")


def test_jax_f32_gradient_strays_further_than_the_ports():
    """Why the gradient tests hold the port against JAX's float64
    gradient: for the lightweight network (B=8, 32x32) the port's f32
    gradient is within 1e-3 relative L2 of it on every parameter, while
    JAX's own f32 gradient strays more than ten times as far."""
    fam = build_family(family_raw("geometry_aware_lightweight"), seed=22)
    (_, jm, _), _, (params, stats) = fam
    rng = np.random.default_rng(6)
    batch = make_train_batch(rng, 8, 32, 32)
    mask = rng.uniform(size=(8, 32, 32, 1)).astype(np.float32)
    port, ref = family_grads(fam, batch, mask)
    ja, _ = family_args("geometry_aware_lightweight", batch)

    def loss_of(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, *ja,
                          train=True, mutable=["batch_stats",
                                               "intermediates"])
        return jnp.mean(out * mask)

    jax32 = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_of))(
        jax.tree_util.tree_map(jnp.asarray, params)))
    want = dict(leaves(ref))

    def worst(tree):
        errs = []
        for path, g in leaves(tree):
            name = jax.tree_util.keystr(path)
            if "film" in name and ("fc1" in name or "fc2" in name) \
                    and name.endswith("['bias']"):
                continue  # zero but for round-off on every side
            w = want[path].astype(np.float64)
            errs.append(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-10))
        return max(errs)

    port_err, jax_err = worst(port), worst(jax32)
    print(f"worst relative L2 against JAX's float64 gradient: port f32 "
          f"{port_err:.3g}, JAX f32 {jax_err:.3g}")
    assert port_err < 1e-3
    assert jax_err > 10 * port_err
