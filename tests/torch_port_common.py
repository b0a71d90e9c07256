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
from cadepth_tpu.models import factory as jax_factory
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


def make_train_batch(rng: np.random.Generator, b: int = TRAIN_B,
                     h: int = TRAIN_H, w: int = TRAIN_W
                     ) -> Dict[str, np.ndarray]:
    """rgb in (0, 1), gt depth in (0, 10) with ~10 % of pixels at or below
    the 0.1 m validity floor, a distinct K per sample drawn wide (fx, fy
    in 0.5-1.5 W, the principal point in 0.3-0.7 of the image): FiLM's
    BatchNorm1d normalises the 4 camera vectors, and similar ones make its
    gradient ill-conditioned."""
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


def sample_inputs(architecture: str, h: int = TRAIN_H, w: int = TRAIN_W,
                  b: int = TRAIN_B) -> tuple:
    """The positional JAX model inputs of a family at (b, h, w), as
    ``init_random`` takes them to read the variables' shapes."""
    sample = make_train_batch(np.random.default_rng(0), b, h, w)
    sample["rays"] = sample["rgb"]
    return jax_factory.model_inputs(
        architecture, {k: jnp.asarray(v) for k, v in sample.items()})[0]


def setup_training(raw: Dict[str, Any], seed: int, steps: int):
    """Both sides of a train-step comparison from one seed: (JAX config,
    model, loss, optimizer, state), (port config, model, loss, optimizer,
    schedule) and ``steps`` numpy batches. The port's model holds the
    JAX variables, converted."""
    rng = np.random.default_rng(seed)
    jcfg = jax_config.config_from_dict(raw)
    pcfg = port_config.config_from_dict(raw)
    jm, jloss = jax_ts.build_model_and_loss(jcfg)
    params, stats = init_random(jm, rng, *sample_inputs(
        jcfg.model.architecture, jcfg.data.input_height,
        jcfg.data.input_width))
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


# -- the model families at a small size --------------------------------------

FAMILY_F = 8


def family_raw(architecture: str, use_amp: bool = False, **model):
    """A config dict of one family at f=8, 64x64 (f32 unless
    ``use_amp``)."""
    return {"model": {"architecture": architecture,
                      "init_features": FAMILY_F, **model},
            "data": {"input_height": TRAIN_H, "input_width": TRAIN_W},
            "training": {"use_amp": use_amp, "batch_size": TRAIN_B,
                         "num_epochs": 20}}


def build_family(raw: Dict[str, Any], seed: int):
    """(JAX config, model, loss), (port config, model in eval mode,
    loss), and the JAX variables (params, batch_stats) drawn from
    ``seed`` (rotating PCL heads where the family has PCLs), loaded into
    the port's model."""
    jcfg = jax_config.config_from_dict(raw)
    pcfg = port_config.config_from_dict(raw)
    jm, jloss = jax_ts.build_model_and_loss(jcfg)
    params, stats = init_random(jm, np.random.default_rng(seed),
                                *sample_inputs(jcfg.model.architecture))
    model, loss_fn = ts.build_model_and_loss(pcfg, device="cpu")
    load_port(model, params, stats)
    return (jcfg, jm, jloss), (pcfg, model, loss_fn), (params, stats)


def family_args(architecture: str, batch: Dict[str, np.ndarray]):
    """(JAX, port) positional model inputs of ``batch``, the rays from
    the JAX package's ``ray_grid_batch`` on both sides."""
    from cadepth_tpu.geometry.rays import ray_grid_batch

    b = dict(batch)
    b["rays"] = np.array(ray_grid_batch(jnp.asarray(b["intrinsics"]),
                                        b["rgb"].shape[1], b["rgb"].shape[2]))
    args = jax_factory.model_inputs(architecture, b)[0]
    return ([jnp.asarray(a) for a in args],
            [torch.from_numpy(np.asarray(a)) for a in args])


def family_grads(family, batch: Dict[str, np.ndarray], mask: np.ndarray):
    """(port, JAX) gradients of ``mean(depth * mask)`` with the model in
    training mode (batch statistics), the measure of
    ``tests/test_torch_parity.py``, as flax-shaped trees of numpy arrays.

    The port runs in f32. JAX's reference is its model built at
    ``dtype=float64`` under ``jax.enable_x64`` (the modules' own f32
    parts, the batch-norm statistics, FiLM's MLP and the PCL head, stay
    f32): the port's f32 gradient is much closer to it than JAX's own
    f32 gradient on the CPU
    (``test_torch_families_geometry.py::
    test_jax_f32_gradient_strays_further_than_the_ports``).
    """
    (_, jm, _), (pcfg, model, _), (params, stats) = family
    arch = pcfg.model.architecture
    ja, pa = family_args(arch, batch)
    with jax.enable_x64(True):
        jm64 = jm.clone(dtype=jnp.float64)
        ja64 = [jnp.asarray(np.asarray(a), jnp.float64) for a in ja]
        mask64 = jnp.asarray(mask, jnp.float64)

        def loss_of(p):
            out, _ = jm64.apply({"params": p, "batch_stats": stats}, *ja64,
                                train=True, mutable=["batch_stats",
                                                     "intermediates"])
            return jnp.mean(out * mask64)

        want = jax.tree_util.tree_map(
            lambda g: np.asarray(g, np.float32),
            jax.jit(jax.grad(loss_of))(jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), params)))
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    names, ps = zip(*model.named_parameters())
    loss = (model(*pa) * torch.from_numpy(mask)).mean()
    grads = torch.autograd.grad(loss, ps)
    model.load_state_dict(saved)
    model.eval()
    got, _ = convert.to_jax({**dict(zip(names, grads)),
                             **dict(model.named_buffers())})
    return got, want


def assert_grads_close(got, want, tol: float) -> None:
    """Each parameter's gradient within relative L2 ``tol`` of JAX's, and
    the whole tree within ``tol / 10`` (``tests/test_torch_parity.py``'s
    measure). The biases of the FiLM MLP's two layers feed a batch norm,
    so their gradient is zero but for round-off on both sides: those are
    held at an absolute 1e-5."""
    paths = dict(leaves(want))
    assert len(leaves(got)) == len(paths)
    num = den = 0.0
    for path, g in leaves(got):
        name = jax.tree_util.keystr(path)
        w = paths[path].astype(np.float64)
        if "film" in name and ("fc1" in name or "fc2" in name) \
                and name.endswith("['bias']"):
            assert np.abs(g).max() < 1e-5 and np.abs(w).max() < 1e-5, name
            continue
        num += float(np.sum((g - w) ** 2))
        den += float(np.sum(w ** 2))
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-10)
        assert err < tol, f"{name}: rel-L2 {err:.3e} (tol {tol})"
    assert np.sqrt(num / max(den, 1e-20)) < tol / 10.0


def family_forward(family, b: int, seed: int, use_amp: bool = False):
    """(port, JAX) eval-mode depths of a family on a seeded batch of
    ``b``, and the port's intermediates dict; with ``use_amp`` both
    models compute in bf16 over the same f32 variables."""
    (jcfg, _, _), (pcfg, model, _), (params, stats) = family
    arch = pcfg.model.architecture
    if use_amp:
        import dataclasses

        jcfg = dataclasses.replace(jcfg, training=dataclasses.replace(
            jcfg.training, use_amp=True))
        pcfg = dataclasses.replace(pcfg, training=dataclasses.replace(
            pcfg.training, use_amp=True))
        model = ts.build_model_and_loss(pcfg, device="cpu")[0]
        load_port(model, params, stats)
    jm = jax_ts.build_model_and_loss(jcfg)[0]
    ja, pa = family_args(arch, make_train_batch(np.random.default_rng(seed),
                                                b))
    want = np.asarray(jax.jit(jm.apply)(jax_variables(params, stats), *ja))
    record: Dict[str, Any] = {}
    with torch.no_grad():
        got = model.eval()(*pa, record).numpy()
    return got, want, record


def full_width_counts(architecture: str, **model) -> Tuple[int, int]:
    """(port, JAX) parameter counts of a family at the shipped width
    (f=64; the lightweight network caps it at 32), from shapes alone."""
    from cadepth_tpu_torch.models import factory as port_factory

    jm = jax_factory.create_model(architecture, init_features=64, **model)
    args = [jax.ShapeDtypeStruct(np.shape(a), jnp.float32)
            for a in sample_inputs(architecture, 32, 32, 1)]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)
    with torch.device("meta"):
        port = port_factory.create_model(architecture, init_features=64,
                                         device="meta", **model)
    return (port_factory.count_parameters(port),
            jax_factory.count_parameters(shapes["params"]))


def assert_round_trip_exact(family) -> None:
    """``to_jax(to_torch(p)) == p`` for the family's variables, and from
    the loaded model's own ``state_dict``."""
    _, (_, model, _), (params, stats) = family
    for p2, s2 in (convert.to_jax(convert.to_torch(params, stats)),
                   convert.to_jax(model.state_dict())):
        for got, want in ((p2, params), (s2, stats)):
            paths = dict(leaves(want))
            assert len(leaves(got)) == len(paths)
            for path, g in leaves(got):
                assert np.array_equal(g, paths[path]), \
                    jax.tree_util.keystr(path)
