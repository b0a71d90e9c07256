"""The port's schedule, optimizer and train-mode BatchNorm against JAX's.

- ``build_lr_schedule`` against the JAX package's optax schedule at
  every step of a run, for step, cosine and none, with and without
  warmup: rtol 1e-6 (float32 arithmetic in both; ``cos`` may differ by
  an ulp).
- ``build_optimizer``: adam, adamw and sgd (Nesterov), each with and
  without global-norm clipping, 5 updates on fixed numpy gradients (one
  update's norm above the clip value), parameters at atol 1e-6.
- Train-mode BatchNorm2d and FiLM's BatchNorm1d against flax's
  ``BatchNorm(use_running_average=False)``: outputs at atol 1e-5,
  updated running statistics at rtol 1e-6 (the biased variance, momentum
  0.99); FiLM at B == 1 skips its BN and leaves the statistics as they
  are.
"""

from __future__ import annotations

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cadepth_tpu import config as jax_config
from cadepth_tpu.models import film as jax_film
from cadepth_tpu.training.schedule import build_lr_schedule as jax_schedule
from cadepth_tpu.training.train_state import build_optimizer as jax_optimizer
from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.models.film import FiLMLayer
from cadepth_tpu_torch.models.layers import BatchNorm2d
from cadepth_tpu_torch.training.schedule import build_lr_schedule
from cadepth_tpu_torch.training.train_state import build_optimizer

from torch_port_common import init_random, nchw, nhwc


def _opt(**kw):
    raw = {"optimization": kw}
    return (jax_config.config_from_dict(raw).optimization,
            port_config.config_from_dict(raw).optimization)


@pytest.mark.parametrize("warmup", [0, 2])
@pytest.mark.parametrize("scheduler", ["step", "cosine", "none", "plateau"])
def test_schedule_matches_optax_every_step(scheduler, warmup):
    jopt, popt = _opt(lr_scheduler=scheduler, lr_warmup_epochs=warmup,
                      learning_rate=3e-4, lr_step_size=3, lr_gamma=0.5,
                      lr_min=1e-6)
    steps_per_epoch, epochs = 7, 12
    want = jax_schedule(jopt, steps_per_epoch, epochs)
    got = build_lr_schedule(popt, steps_per_epoch, epochs)
    for s in range(steps_per_epoch * epochs + 5):
        np.testing.assert_allclose(got(s), float(want(jnp.int32(s))),
                                   rtol=1e-6, atol=1e-12, err_msg=str(s))
    if warmup:
        assert got(0) == 0.0 and got(steps_per_epoch * warmup) == \
            pytest.approx(3e-4)


def test_schedule_rejects_unknown():
    _, popt = _opt(lr_scheduler="exponential")
    with pytest.raises(ValueError, match="lr_scheduler"):
        build_lr_schedule(popt, 10, 5)


SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_optimizer_matches_optax(optimizer, clip):
    jopt, popt = _opt(optimizer=optimizer, gradient_clip=clip,
                      gradient_clip_value=1.0, weight_decay=0.01,
                      learning_rate=1e-2, lr_scheduler="none",
                      lr_warmup_epochs=1)
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    # norms ~0.4 per update, and the third one ~4: clipped when clip is on
    grads = [{k: (rng.normal(scale=0.1, size=s) * (10 if t == 2 else 1))
              .astype(np.float32) for k, s in SHAPES.items()}
             for t in range(5)]
    lr = build_lr_schedule(popt, 2, 4)
    tx = jax_optimizer(jopt, jax_schedule(jopt, 2, 4))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = build_optimizer(popt, tp.values())
    for t, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step(lr(t))
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0, err_msg=k)


def test_clip_is_optax_not_torch():
    """Below the threshold optax leaves the gradient as it is; above it,
    g / norm * max (torch's clip_grad_norm_ divides by norm + 1e-6)."""
    from cadepth_tpu_torch.training.train_state import clip_by_global_norm_

    g = [torch.tensor([0.6, 0.8]) * 0.999]
    clip_by_global_norm_(g, 1.0)
    assert torch.equal(g[0], torch.tensor([0.6, 0.8]) * 0.999)
    g = [torch.tensor([3.0, 4.0])]
    clip_by_global_norm_(g, 1.0)
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]) / 5.0 * 1.0)


def _flax_bn(x, mean, var, scale, bias):
    bn = fnn.BatchNorm(use_running_average=False, dtype=jnp.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    y, upd = bn.apply(variables, x, mutable=["batch_stats"])
    return np.asarray(y), {k: np.asarray(v)
                           for k, v in upd["batch_stats"].items()}


def test_batchnorm2d_train_matches_flax():
    rng = np.random.default_rng(1)
    c = 6
    x = (rng.normal(size=(4, 5, 7, c)) * 3 + 2).astype(np.float32)
    mean = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.5, 2, c).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    want, stats = _flax_bn(x, mean, var, scale, bias)
    bn = BatchNorm2d(c)
    with torch.no_grad():
        for name, a in (("weight", scale), ("bias", bias),
                        ("running_mean", mean), ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(a))
    bn.train()
    got = nhwc(bn(nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                               rtol=1e-6)
    # eval mode is torch's own, with the updated statistics
    bn.eval()
    ref = torch.nn.functional.batch_norm(
        nchw(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
        False, 0.0, bn.eps)
    assert torch.equal(bn(nchw(x)), ref)


@pytest.mark.parametrize("b", [1, 4])
def test_film_batchnorm1d_train_matches_flax(b):
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(b, 3, 4, 16)).astype(np.float32)
    cam = rng.normal(0.0, 0.5, (b, 4)).astype(np.float32)
    jm = jax_film.FiLMLayer(16, dtype=jnp.float32)
    params, stats = init_random(jm, rng, jnp.asarray(feats), jnp.asarray(cam))
    want, upd = jm.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(feats), jnp.asarray(cam), train=True,
                         mutable=["batch_stats"])
    port = FiLMLayer(16)
    port.load_state_dict(convert.to_torch(params, stats))
    port.train()
    with torch.no_grad():
        got = nhwc(port(nchw(feats), torch.from_numpy(cam)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    _, got_stats = convert.to_jax(port.state_dict())
    for name in ("bn1", "bn2"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                got_stats[name][k], np.asarray(upd["batch_stats"][name][k]),
                rtol=1e-6, atol=1e-7, err_msg=f"{name}/{k}")
            if b == 1:
                assert np.array_equal(got_stats[name][k], stats[name][k])
