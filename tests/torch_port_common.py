"""Shared set-up of the ``test_torch_*`` files: JAX variables made from a
seed, given random batch statistics and a rotated PCL head, and handed to
the port through ``cadepth_tpu_torch.convert``.

Data passes between the two packages as numpy arrays only.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cadepth_tpu import config as jax_config
from cadepth_tpu.training import train_state as jax_ts
from cadepth_tpu.training.schedule import build_lr_schedule as jax_schedule
from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.training import train_state as ts
from cadepth_tpu_torch.training.schedule import build_lr_schedule

# pytest-xdist runs the tests in several worker processes at once, and
# PyTorch's default of one intra-op thread per core in each of them
# oversubscribes the CPU; the port's tests use small tensors, so each
# process takes one thread.
torch.set_num_threads(1)

# fc_transform bias [sx, sy, tx, ty, rot, shear] of a PCL head that
# zooms, shifts, rotates and shears (the identity head warps nothing).
PCL_BIAS = np.array([1.04, 0.95, 0.03, -0.02, 0.04, 0.03], np.float32)


def to_numpy_tree(tree) -> Dict[str, Any]:
    """A flax variable collection (or its shapes) as nested dicts of
    float32 numpy arrays (zeros for shapes)."""
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, jax.ShapeDtypeStruct):
        return np.zeros(tree.shape, np.float32)
    return np.asarray(tree, np.float32)


def randomize(params: Dict[str, Any], batch_stats: Dict[str, Any],
              rng: np.random.Generator) -> Tuple[Dict, Dict]:
    """Give every BN statistic a random value (mean ~ N(0, 0.1), var ~
    U(0.5, 2)) and every PCL head a small random kernel with PCL_BIAS,
    so that eval-mode BN and the warp both do real work."""

    def stats(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = stats(v)
            elif k == "mean":
                out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            else:
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        return out

    def pcl(tree):
        out = {}
        for k, v in tree.items():
            if k == "fc_transform":
                out[k] = {"kernel": rng.normal(0.0, 0.002, v["kernel"].shape)
                          .astype(np.float32),
                          "bias": PCL_BIAS.copy()}
            elif isinstance(v, dict):
                out[k] = pcl(v)
            else:
                out[k] = v
        return out

    return pcl(params), stats(batch_stats)


def jax_variables(params, batch_stats) -> Dict[str, Any]:
    out = {"params": jax.tree_util.tree_map(np.asarray, params)}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def init_random(module, rng: np.random.Generator, *args) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of a flax module, drawn with numpy at the
    shapes ``module.init`` would give (no init is compiled): kernels
    N(0, 1/fan_in), biases N(0, 0.05), BN scales U(0.5, 1.5), FiLM's gamma
    bias 1 + N(0, 0.05); then randomized as :func:`randomize` says."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def draw(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = draw(v, path + (k,))
                continue
            shape = tuple(v.shape)
            if k == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                a = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
            elif k == "scale":
                a = rng.uniform(0.5, 1.5, shape)
            elif path and path[-1] == "fc_gamma":
                a = 1.0 + rng.normal(0.0, 0.05, shape)
            else:
                a = rng.normal(0.0, 0.05, shape)
            out[k] = a.astype(np.float32)
        return out

    params = draw(shapes["params"])
    batch_stats = to_numpy_tree(shapes.get("batch_stats", {}))
    return randomize(params, batch_stats, rng)


def load_port(module: torch.nn.Module, params, batch_stats) -> torch.nn.Module:
    """Load converted JAX variables into a port module, strictly, and put
    it in eval mode."""
    module.load_state_dict(convert.to_torch(params, batch_stats))
    return module.eval()


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW channels_last tensor, as the port's models hold
    their feature maps."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


# The train-step comparisons: the f32 flagship at f=8, 64x64, batch 4,
# the shipped optimizer and step schedule with 2 warmup epochs of 2 steps
TRAIN_H = TRAIN_W = 64
TRAIN_B = 4
STEPS_PER_EPOCH = 2
TRAIN_RAW = {"model": {"architecture": "geometry_aware", "init_features": 8},
             "data": {"input_height": TRAIN_H, "input_width": TRAIN_W},
             "training": {"use_amp": False, "batch_size": TRAIN_B,
                          "num_epochs": 20}}


def make_train_batch(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """rgb in (0, 1), gt depth in (0, 10) with ~10 % of pixels at or below
    the 0.1 m validity floor, a distinct K per sample drawn wide (fx, fy
    in 0.5-1.5 W, the principal point in 0.3-0.7 of the image): FiLM's
    BatchNorm1d normalises the 4 camera vectors, and similar ones make its
    gradient ill-conditioned."""
    b, h, w = TRAIN_B, TRAIN_H, TRAIN_W
    rgb = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 9.5, (b, h, w, 1)).astype(np.float32)
    low = rng.uniform(0, 1, depth.shape) < 0.1
    depth[low] = rng.uniform(0.0, 0.1, int(low.sum()))
    k = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    k[:, 0, 0] = rng.uniform(0.5, 1.5, b) * w
    k[:, 1, 1] = rng.uniform(0.5, 1.5, b) * w
    k[:, 0, 2] = rng.uniform(0.3, 0.7, b) * w
    k[:, 1, 2] = rng.uniform(0.3, 0.7, b) * h
    k4 = np.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]], -1)
    return {"rgb": rgb, "depth": depth, "intrinsics": k, "k4": k4}


def setup_training(raw: Dict[str, Any], seed: int, steps: int):
    """Both sides of a train-step comparison from one seed: (JAX config,
    model, loss, optimizer, state), (port config, model, loss, optimizer,
    schedule) and ``steps`` numpy batches. The port's model holds the
    JAX variables, converted."""
    rng = np.random.default_rng(seed)
    jcfg = jax_config.config_from_dict(raw)
    pcfg = port_config.config_from_dict(raw)
    jm, jloss = jax_ts.build_model_and_loss(jcfg)
    sample = make_train_batch(np.random.default_rng(0))
    params, stats = init_random(jm, rng, jnp.asarray(sample["rgb"]),
                                jnp.asarray(sample["rgb"]),
                                jnp.asarray(sample["k4"]))
    tx = jax_ts.build_optimizer(
        jcfg.optimization,
        jax_schedule(jcfg.optimization, STEPS_PER_EPOCH,
                     jcfg.training.num_epochs))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_ts.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=tx.init(jparams))
    model, loss_fn = ts.build_model_and_loss(pcfg, device="cpu")
    model.load_state_dict(convert.to_torch(params, stats))
    optimizer = ts.build_optimizer(pcfg.optimization, model.parameters())
    schedule = build_lr_schedule(pcfg.optimization, STEPS_PER_EPOCH,
                                 pcfg.training.num_epochs)
    batches = [make_train_batch(rng) for _ in range(steps)]
    return (jcfg, jm, jloss, tx, state), (pcfg, model, loss_fn, optimizer,
                                          schedule), batches


def torch_batch(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def leaves(tree):
    """(path, leaf) pairs of a nested dict, for comparing two trees."""
    return jax.tree_util.tree_leaves_with_path(tree)


def chain_theta(theta: torch.Tensor, partials: torch.Tensor, height: int,
                width: int, align_corners: bool) -> torch.Tensor:
    """d_theta (B, 2, 3) f32 from the (B, 6) partials of the loss with
    respect to the six line coefficients [A, B, C, p, q, r], by autograd
    through the port's ``warp_coeffs``: the reference of the closed form
    ``chain_theta_closed`` that the plain backwards and the kernels'
    theta kernel use."""
    from cadepth_tpu_torch.ops.affine_warp import warp_coeffs

    with torch.enable_grad():
        th = theta.detach().to(torch.float32).requires_grad_(True)
        co = warp_coeffs(th, height, width, align_corners)
        (d_theta,) = torch.autograd.grad(co, th, partials)
    return d_theta
