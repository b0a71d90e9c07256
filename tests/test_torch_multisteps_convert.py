"""``optax.MultiSteps`` mid-accumulation converts into the port: a
JAX train state with one micro-batch of grad_accum_steps 2 taken goes
through ``convert.train_state_to_torch`` and back exactly, and the port's
``Optimizer.update`` completes the update as optax completes it."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from torch_port_common import leaves
from cadepth_tpu import config as jax_config
from cadepth_tpu.training import train_state as jax_ts
from cadepth_tpu_torch import config as port_config
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.training import train_state as ts


def numpy_state(state):
    return jax.tree_util.tree_map(np.asarray, state)


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_multisteps_mid_accumulation_completes_in_the_port(tmp_path,
                                                           optimizer):
    """grad_accum_steps 2, one micro-batch in: an optax.MultiSteps state
    (Adam's or SGD momentum's moments from earlier updates, a running
    mean of one gradient, clip 1.0) converts into the port and back
    exactly; given the same second gradient, the port's Optimizer.update
    completes the update where optax's does: rtol 1e-5 and atol 1e-4 of
    the learning rate (an update moves an entry by about lr; optax
    computes Adam's bias correction 1 - b2^t in f32, where the
    cancellation at t = 4 costs ~1.5e-5 of nu_hat, and torch in
    double)."""
    raw = {"model": {"architecture": "geometry_aware", "init_features": 4},
           "data": {"input_height": 32, "input_width": 32},
           "optimization": {"optimizer": optimizer, "learning_rate": 1e-2,
                            "grad_accum_steps": 2, "lr_scheduler": "none",
                            "lr_warmup_epochs": 0, "gradient_clip": True,
                            "gradient_clip_value": 1.0},
           "training": {"use_amp": False}}
    pcfg = port_config.config_from_dict(raw)
    jcfg = jax_config.config_from_dict(raw)
    model, loss_fn = ts.build_model_and_loss(pcfg, device="cpu")
    opt = ts.build_optimizer(pcfg.optimization, model.parameters())
    step = ts.make_train_step(pcfg, model, loss_fn, opt, lambda s: 1e-2)
    params, stats = convert.to_jax(model.state_dict())
    tx = jax_ts.build_optimizer(jcfg.optimization, lambda s: 1e-2)
    rng = np.random.default_rng(0)

    def like(tree, scale):
        return jax.tree_util.tree_map(
            lambda a: rng.normal(0, scale, a.shape).astype(np.float32),
            tree)

    state = numpy_state(tx.init(params))
    inner = state.inner_opt_state
    clip, core = inner
    if optimizer == "sgd":
        core = (core[0]._replace(trace=like(params, 0.1)),
                core[1]._replace(count=np.asarray(3, np.int32)))
    else:
        # moments as three Adam updates leave them: nu at least mu^2
        mu = like(params, 0.1)
        nu = jax.tree_util.tree_map(
            lambda m: (m * m * rng.uniform(1.0, 3.0, m.shape) + 1e-6)
            .astype(np.float32), mu)
        core = (core[0]._replace(count=np.asarray(3, np.int32), mu=mu,
                                 nu=nu),) + \
            tuple(c._replace(count=np.asarray(3, np.int32))
                  if getattr(c, "_fields", ()) == ("count",) else c
                  for c in core[1:])
    state = state._replace(
        mini_step=np.asarray(1, np.int32),
        gradient_step=np.asarray(3, np.int32),
        acc_grads=like(params, 0.5), inner_opt_state=(clip, core))
    jstate = jax_ts.TrainState(step=np.asarray(7, np.int32), params=params,
                               batch_stats=stats, opt_state=state)
    convert.train_state_to_torch(jstate, step)
    assert step.updates == 7 and opt.updates == 3 and opt._micro == 1
    back = convert.train_state_to_jax(step, numpy_state(tx.init(params)))
    for (path, x), (_, y) in zip(leaves(back[3]), leaves(state)):
        assert np.array_equal(np.asarray(x), np.asarray(y)), \
            jax.tree_util.keystr(path)

    grads = like(params, 0.5)
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                           jax.tree_util.tree_map(jnp.asarray, state),
                           jax.tree_util.tree_map(jnp.asarray, params))
    want = optax.apply_updates(jax.tree_util.tree_map(jnp.asarray, params),
                               updates)
    torch_grads = convert.to_torch(grads)
    for name, p in model.named_parameters():
        p.grad = torch_grads[name].clone()
    assert opt.update(lambda s: 1e-2)
    assert opt.updates == 4 and opt._micro == 0
    got, _ = convert.to_jax(model.state_dict())
    for (path, x), (_, y) in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-5,
                                   atol=1e-4 * 1e-2,
                                   err_msg=jax.tree_util.keystr(path))
