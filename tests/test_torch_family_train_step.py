"""Training steps of the port's ``IntrinsicsConditionedUNet`` (a FiLM
family, ``intrinsics_unet`` without attention) against the JAX
package's, with the method and bounds of ``test_torch_train_step.py``.

The f32 model at init_features 8, 64x64, batch 4, from the same
converted parameters and random BN statistics, K drawn wide; the shipped
optimizer (AdamW, weight decay 1e-5, clip 1.0) and the step schedule with
a warmup of 4 steps (learning rate 0, 2.5e-5, 5e-5, 7.5e-5, 1e-4); both
sides take the same numpy batches. Held: the four losses and their
total at every step at rtol 1e-4; grad_norm, grad_max and grad_min at
rtol 5e-3; the BN running statistics (rtol 1e-5 after the first two
steps, whose parameters are equal, then 1e-3); the parameters after the
steps within the learning rates' sum of JAX's, their median difference
within 2 % of it; and the eval step on the trained variables.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cadepth_tpu.training import train_state as jax_ts
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.training import train_state as ts

from torch_port_common import (TRAIN_RAW, leaves, make_train_batch,
                               setup_training, torch_batch)

STEPS = 5
RAW = {**TRAIN_RAW, "model": {"architecture": "intrinsics_unet",
                              "init_features": 8, "use_attention": False}}
LOG_KEYS = ("total_loss", "si_loss", "grad_loss", "smooth_loss",
            "reproj_loss", "grad_norm", "grad_max", "grad_min")


@pytest.fixture(scope="module")
def steps():
    (jcfg, jm, jloss, tx, state), (pcfg, model, loss_fn, optimizer,
                                   schedule), batches = setup_training(
        RAW, 37, STEPS)
    assert type(model).__name__ == "IntrinsicsConditionedUNet"
    assert type(jm).__name__ == "IntrinsicsConditionedUNet"
    jstep = jax_ts.make_train_step(jcfg, jm, jloss, tx, donate=False)
    pstep = ts.make_train_step(pcfg, model, loss_fn, optimizer, schedule)
    out = {"jax_logs": [], "port_logs": [], "jax_stats": [],
           "port_stats": []}
    for b in batches:
        state, logs = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        out["jax_logs"].append({k: float(v) for k, v in logs.items()})
        out["port_logs"].append({k: float(v)
                                 for k, v in pstep(torch_batch(b)).items()})
        out["jax_stats"].append(jax.tree_util.tree_map(np.asarray,
                                                       state.batch_stats))
        out["port_stats"].append(convert.to_jax(model.state_dict())[1])
    out["jax_params"] = jax.tree_util.tree_map(np.asarray, state.params)
    out["port_params"] = convert.to_jax(model.state_dict())[0]
    out["lrs"] = [schedule(s) for s in range(STEPS)]
    out["port"] = (pcfg, model, loss_fn)
    out["jax"] = (jcfg, jm, jloss, state)
    out["updates"] = pstep.updates
    return out


def test_logs_match_every_step(steps):
    assert steps["updates"] == STEPS
    for step, (got, want) in enumerate(zip(steps["port_logs"],
                                           steps["jax_logs"])):
        assert set(got) == set(want) == set(LOG_KEYS)
        for k in LOG_KEYS:
            assert np.isfinite(got[k]), (step, k)
            rtol = 5e-3 if k.startswith("grad_") else 1e-4
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       err_msg=f"step {step} {k}")


def test_bn_running_statistics_match_every_step(steps):
    for step, (got, want) in enumerate(zip(steps["port_stats"],
                                           steps["jax_stats"])):
        paths = dict(leaves(want))
        assert len(leaves(got)) == len(paths)
        rtol, atol = (1e-5, 1e-6) if step < 2 else (1e-3, 5e-5)
        for path, g in leaves(got):
            np.testing.assert_allclose(
                g, paths[path], rtol=rtol, atol=atol,
                err_msg=f"step {step} {jax.tree_util.keystr(path)}")


def test_parameters_match_after_the_steps(steps):
    lrs = steps["lrs"]
    assert lrs[0] == 0.0 and lrs[-1] == pytest.approx(1e-4)
    bound = sum(lrs)
    want = dict(leaves(steps["jax_params"]))
    diffs = []
    for path, g in leaves(steps["port_params"]):
        d = np.abs(g - want[path])
        diffs.append(d.ravel())
        assert d.max() <= bound, (jax.tree_util.keystr(path), d.max(), bound)
    assert np.median(np.concatenate(diffs)) <= 0.02 * bound


def test_eval_step_matches(steps):
    """The loss components and the 12 metrics of make_eval_step on the
    port's trained variables, rtol 1e-4 (atol 1e-6); no pcl_max_rot, as
    JAX's family sows none."""
    pcfg, model, loss_fn = steps["port"]
    jcfg, jm, jloss, state = steps["jax"]
    batch = make_train_batch(np.random.default_rng(98))
    params, stats = convert.to_jax(model.state_dict())
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             stats))
    want = jax_ts.make_eval_step(jcfg, jm, jloss)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    got = ts.make_eval_step(pcfg, model, loss_fn)(torch_batch(batch))
    assert set(got) == set(want)
    assert len(got) == 5 + 12 and "pcl_max_rot" not in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
