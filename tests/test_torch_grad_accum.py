"""Gradient accumulation (``optimization.grad_accum_steps``) in the port.

- The port's optimizer with k = 2 and k = 3 against the JAX package's
  ``optax.MultiSteps(chain(clip_by_global_norm, adamw), k)`` over 6
  micro-steps of seeded gradients (one mean above the clip value), with
  a warmup schedule, so the learning rate must advance once per update:
  parameters at rtol 1e-6 (atol 1e-8) after every micro-step, and
  exactly unchanged on the micro-steps that only accumulate.
- The port's train step with k = 2 fed one batch twice lands where k = 1
  fed it once (the mean of two equal gradients is the gradient), as
  ``test_training.py::test_grad_accumulation_equivalence`` shows for JAX;
  BN running statistics move on every micro-step.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cadepth_tpu import config as jax_config
from cadepth_tpu.training.schedule import build_lr_schedule as jax_schedule
from cadepth_tpu.training.train_state import build_optimizer as jax_optimizer
from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch.training import train_state as ts
from cadepth_tpu_torch.training.schedule import build_lr_schedule

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
MICRO_STEPS = 6


def _configs(accum):
    raw = {"optimization": {"optimizer": "adamw", "gradient_clip": True,
                            "gradient_clip_value": 1.0,
                            "weight_decay": 0.01, "learning_rate": 1e-2,
                            "lr_scheduler": "step", "lr_warmup_epochs": 2,
                            "grad_accum_steps": accum}}
    return (jax_config.config_from_dict(raw).optimization,
            port_config.config_from_dict(raw).optimization)


@pytest.mark.parametrize("accum", [2, 3])
def test_optimizer_matches_optax_multisteps(accum):
    jopt, popt = _configs(accum)
    rng = np.random.default_rng(accum)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    # norms ~0.4; micro-step 3 ~4, so a mean that holds it is clipped
    grads = [{k: (rng.normal(scale=0.1, size=s) * (10 if t == 3 else 1))
              .astype(np.float32) for k, s in SHAPES.items()}
             for t in range(MICRO_STEPS)]
    tx = jax_optimizer(jopt, jax_schedule(jopt, 1, 10))
    assert isinstance(tx, optax.MultiSteps)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = ts.build_optimizer(popt, tp.values())
    schedule = build_lr_schedule(popt, 1, 10)
    assert schedule(0) == 0.0 and schedule(1) > 0.0
    for t, g in enumerate(grads):
        before = {k: p.detach().clone() for k, p in tp.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        updated = opt.update(schedule)
        assert updated == ((t + 1) % accum == 0)
        assert opt.updates == (t + 1) // accum
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-8, err_msg=f"{t} {k}")
            if not updated:
                assert torch.equal(tp[k].detach(), before[k])
        opt.zero_grad()
    assert opt.updates == MICRO_STEPS // accum


def _step(accum, batch):
    cfg = port_config.config_from_dict({
        "model": {"architecture": "geometry_aware", "init_features": 4},
        "data": {"input_height": 32, "input_width": 32},
        "training": {"use_amp": False, "batch_size": 2},
        "optimization": {"grad_accum_steps": accum, "gradient_clip": False,
                         "lr_scheduler": "none", "lr_warmup_epochs": 0}})
    model, loss_fn = ts.build_model_and_loss(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = ts.build_optimizer(cfg.optimization, model.parameters())
    return model, ts.make_train_step(cfg, model, loss_fn, opt,
                                     lambda s: 1e-3)


def test_two_micro_steps_of_one_batch_equal_one_step():
    rng = np.random.default_rng(7)
    b, h, w = 2, 32, 32
    k = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    k[:, 0, 0] = k[:, 1, 1] = [20.0, 40.0]
    k[:, 0, 2], k[:, 1, 2] = [12.0, 18.0], [14.0, 17.0]
    batch = {"rgb": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
             "depth": rng.uniform(0.3, 9.5, (b, h, w, 1)).astype(np.float32),
             "intrinsics": k,
             "k4": np.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]],
                            -1)}
    batch = {key: torch.from_numpy(v) for key, v in batch.items()}
    model1, step1 = _step(1, batch)
    model2, step2 = _step(2, batch)
    p0 = {n: p.detach().clone() for n, p in model2.named_parameters()}
    s0 = {n: s.clone() for n, s in model2.named_buffers()}
    step1(batch)
    logs = step2(batch)
    assert np.isfinite(float(logs["grad_norm"]))
    for n, p in model2.named_parameters():  # the first micro-step only adds
        assert torch.equal(p.detach(), p0[n]), n
    moved = [n for n, s in model2.named_buffers()
             if "running" in n and not torch.equal(s, s0[n])]
    assert moved, "the micro-step left the BN running statistics as they were"
    step2(batch)
    assert step2.optimizer.updates == 1 and step2.updates == 2
    want = dict(model1.named_parameters())
    for n, p in model2.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[n].detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
