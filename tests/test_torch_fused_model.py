"""The flagship with ``model.pcl_warp: fused`` in the port against the
JAX package's (the small flagship: f32, init_features 8, 64x64, B = 4,
K drawn wide as ``torch_port_common.py`` draws it, rotating PCL heads).

- ``convert.to_torch`` carries a fused-mode flax tree unchanged: the PCL
  has the same parameters in every mode, the port model loads it
  strictly and ``to_jax`` gives it back exactly.
- The eval-mode forward against JAX's (Pallas interpret mode): atol and
  rtol 1e-3 m, as ``test_torch_model.py`` holds the two-pass flagship.
- One ``make_grad_fn`` gradient against JAX's ``make_grad_fn``: the
  global norm, max and min of the gradient at rtol 5e-3, the bound
  ``test_torch_train_step.py`` sets for them (this network's gradient
  moves by 1.5e-4 to 1e-2 under 1e-6 parameter noise in JAX itself), and
  each PCL head's gradient norm (through the banded backward's d_theta)
  at the same bound; the BN statistics stay as they were.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadepth_tpu.geometry.rays import ray_grid_batch
from cadepth_tpu.models.geometry_aware import (
    GeometryAwareNetwork as JaxGeometryAwareNetwork,
)
from cadepth_tpu.training import train_state as jax_ts
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.geometry.rays import ray_grid_batch as port_rays
from cadepth_tpu_torch.models import factory
from cadepth_tpu_torch.ops import fused_warp as fw
from cadepth_tpu_torch.training import train_state as ts

from torch_port_common import (TRAIN_RAW, jax_variables, leaves,
                               setup_training, torch_batch)

RAW = {**TRAIN_RAW, "model": {**TRAIN_RAW["model"], "pcl_warp": "fused"}}


@pytest.fixture(scope="module")
def fused():
    """Both sides from one seed: (JAX config, model, loss, state), (port
    config, model, loss) and a batch."""
    (jcfg, jm, jloss, _, state), (pcfg, model, loss_fn, _, _), batches = \
        setup_training(RAW, 41, 1)
    assert jm.pcl_warp == "fused" and pcfg.model.pcl_warp == "fused"
    return (jcfg, jm, jloss, state), (pcfg, model, loss_fn), batches[0]


def test_fused_tree_converts_unchanged(fused):
    (_, _, _, state), (_, model, _), _ = fused
    params = jax.tree_util.tree_map(np.asarray, state.params)
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    fresh = factory.create_model("geometry_aware", init_features=8,
                                 pcl_warp="fused", dtype=torch.float32,
                                 device="cpu")
    fresh.load_state_dict(convert.to_torch(params, stats))  # strict
    assert all(p.warp is fw.fused_warp for p in fresh.modules()
               if hasattr(p, "fc_transform"))
    got_params, got_stats = convert.to_jax(fresh.state_dict())
    for got, want in ((got_params, params), (got_stats, stats)):
        paths = dict(leaves(want))
        assert len(leaves(got)) == len(paths)
        for path, g in leaves(got):
            assert np.array_equal(g, paths[path]), jax.tree_util.keystr(path)


def test_forward_matches_jax(fused):
    (_, _, _, state), (_, model, _), batch = fused
    jm = JaxGeometryAwareNetwork(init_features=8, dtype=jnp.float32,
                                 pcl_warp="fused")

    rays = np.array(ray_grid_batch(jnp.asarray(batch["intrinsics"]),
                                   batch["rgb"].shape[1],
                                   batch["rgb"].shape[2]))
    variables = jax_variables(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.batch_stats))
    want = np.asarray(jax.jit(jm.apply)(variables, batch["rgb"], rays,
                                        batch["k4"]))
    model.eval()
    fw.launches = 0
    with torch.no_grad():
        got = model(torch.from_numpy(batch["rgb"]), torch.from_numpy(rays),
                    torch.from_numpy(batch["k4"])).numpy()
    assert fw.launches == 0  # the plain version on the CPU
    assert got.shape == want.shape == (4, 64, 64, 1)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def _pcl_norms(tree):
    return {jax.tree_util.keystr(p): float(np.linalg.norm(g))
            for p, g in leaves(tree) if "pcl" in jax.tree_util.keystr(p)
            and "fc_transform" in jax.tree_util.keystr(p)}


def test_grad_fn_matches_jax(fused):
    (jcfg, jm, jloss, state), (pcfg, model, loss_fn), batch = fused
    want = jax.tree_util.tree_map(np.asarray, jax_ts.make_grad_fn(
        jcfg, jm, jloss)(state, {k: jnp.asarray(v) for k, v in batch.items()}))
    before = {k: v.clone() for k, v in model.named_buffers()}
    grads = ts.make_grad_fn(pcfg, model, loss_fn)(torch_batch(batch))
    for k, v in model.named_buffers():
        assert torch.equal(v, before[k]), k
    got, _ = convert.to_jax({**grads, **dict(model.named_buffers())})
    got_l = [g for _, g in leaves(got)]
    want_l = [w for _, w in leaves(want)]
    assert len(got_l) == len(want_l)
    norm = lambda xs: float(np.sqrt(sum((x.astype(np.float64) ** 2).sum()  # noqa: E731
                                        for x in xs)))
    np.testing.assert_allclose(norm(got_l), norm(want_l), rtol=5e-3)
    np.testing.assert_allclose(max(g.max() for g in got_l),
                               max(w.max() for w in want_l), rtol=5e-3)
    np.testing.assert_allclose(min(g.min() for g in got_l),
                               min(w.min() for w in want_l), rtol=5e-3)
    got_pcl, want_pcl = _pcl_norms(got), _pcl_norms(want)
    assert set(got_pcl) == set(want_pcl) and len(got_pcl) == 10
    for k in want_pcl:
        np.testing.assert_allclose(got_pcl[k], want_pcl[k], rtol=5e-3,
                                   err_msg=k)


def test_fused_model_differs_from_two_pass_only_by_rounding(fused):
    """In band the banded warp is the two-pass function: the same weights
    with pcl_warp two_pass give the same depths (atol 1e-4 m)."""
    _, (_, model, _), batch = fused
    two_pass = factory.create_model("geometry_aware", init_features=8,
                                    dtype=torch.float32, device="cpu")
    two_pass.load_state_dict(model.state_dict())
    args = (torch.from_numpy(batch["rgb"]),
            port_rays(torch.from_numpy(batch["intrinsics"]), 64, 64),
            torch.from_numpy(batch["k4"]))
    model.eval()
    two_pass.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(*args).numpy(),
                                   two_pass(*args).numpy(), atol=1e-4)
