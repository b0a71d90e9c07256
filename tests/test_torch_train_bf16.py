"""One training step of the port's bf16 flagship against the JAX
package's (bf16 compute over f32 parameters, ``training.use_amp``).

The set-up of ``test_torch_train_step.py`` (f=8, 64x64, batch 4,
converted parameters, the same numpy batch on both sides) with one step
at learning rate 1e-4 (no warmup). The two frameworks round bf16 at
different places (fused against unfused epilogues, bias added before or
after the rounding; ``test_torch_model.py`` holds the bf16 forward at
0.1 m), so the tolerances are bf16's, ten times what the port showed:
the losses at rtol 2e-3 (measured 2.2e-4), grad_norm at rtol 1e-2
(1.1e-3), the BN running statistics at atol 2e-3 (1.9e-4); and the
parameters within 2 x lr of JAX's, the most one Adam step can move the
two apart (each side moves a parameter by just under lr, and a gradient
entry whose sign is round-off goes the other way; measured 2.0e-4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cadepth_tpu.training import train_state as jax_ts
from cadepth_tpu_torch import convert
from cadepth_tpu_torch.training import train_state as ts

from torch_port_common import TRAIN_RAW, leaves, setup_training, torch_batch


def test_one_bf16_step_matches_jax():
    raw = {**TRAIN_RAW, "training": {**TRAIN_RAW["training"],
                                     "use_amp": True},
           "optimization": {"lr_warmup_epochs": 0, "learning_rate": 1e-4}}
    (jcfg, jm, jloss, tx, state), (pcfg, model, loss_fn, optimizer,
                                   schedule), batches = setup_training(
        raw, 32, 1)
    assert schedule(0) == np.float32(1e-4)
    jstep = jax_ts.make_train_step(jcfg, jm, jloss, tx, donate=False)
    state, want = jstep(state, {k: jnp.asarray(v)
                                for k, v in batches[0].items()})
    got = ts.make_train_step(pcfg, model, loss_fn, optimizer, schedule)(
        torch_batch(batches[0]))
    for k in ("total_loss", "si_loss", "grad_loss", "smooth_loss",
              "reproj_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-3,
                                   err_msg=k)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-2)
    params, stats = convert.to_jax(model.state_dict())
    want_stats = dict(leaves(jax.tree_util.tree_map(np.asarray,
                                                     state.batch_stats)))
    for path, g in leaves(stats):
        np.testing.assert_allclose(g, want_stats[path], atol=2e-3,
                                   err_msg=jax.tree_util.keystr(path))
    want_params = dict(leaves(jax.tree_util.tree_map(np.asarray,
                                                      state.params)))
    for path, g in leaves(params):
        assert np.abs(g - want_params[path]).max() <= 2e-4, \
            jax.tree_util.keystr(path)
