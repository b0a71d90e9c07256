"""flax variables <-> the port's ``state_dict``.

The port's module and parameter names follow the flax module paths, so
flax ``enc1/conv1/kernel`` is torch ``enc1.conv1.weight``. Leaves map as:

* conv kernel (kh, kw, cin, cout)              -> Conv2d (cout, cin, kh, kw)
* ConvTranspose kernel (kh, kw, cin, cout), spatially flipped
                                               -> ConvTranspose2d (cin, cout, kh, kw)
  (the decoders' only transposed convs are the modules named ``up`` with a
  2x2 kernel; with ``decoder_upsample: resize`` ``up`` is a 3x3 Conv)
* Dense kernel (cin, cout)                     -> Linear (cout, cin)
* BatchNorm and GroupNorm scale/bias           -> weight/bias (a 1-D
  ``weight`` is a norm's scale)
* batch_stats mean/var                         -> running_mean/running_var,
  plus ``num_batches_tracked`` = 0 (GroupNorm has none)
* bias                                         -> bias

In eval mode both frameworks normalise with the stored variance as it
stands, so no correction is applied; the port's train-mode batch norm
stores flax's biased batch variance with flax's momentum.

A whole JAX train state converts too (:func:`train_state_to_torch`,
:func:`train_state_to_jax`), so a JAX run resumes in the port and back:
its ``step`` (micro-steps) is ``TrainStep.updates``; the optax state of
the JAX ``build_optimizer`` maps onto the port's ``Optimizer``: Adam's
``mu``, ``nu`` and ``count`` onto the torch optimizer's ``exp_avg``,
``exp_avg_sq`` and ``step`` (SGD's momentum ``trace`` onto
``momentum_buffer``), the schedule's count onto ``updates``, and
``optax.MultiSteps``' ``acc_grads`` and ``mini_step`` onto the running
mean and its micro-batch count. Moments and accumulators are laid out
as the parameters they belong to. The optax state is read and written by
its field names, so this module needs neither optax nor JAX: pass its
leaves as numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_TRANSPOSED_CONV = "up"


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _kernel_to_torch(module: str, k: np.ndarray) -> np.ndarray:
    if k.ndim == 4:
        if module == _TRANSPOSED_CONV and k.shape[:2] == (2, 2):
            return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))
        return np.transpose(k, (3, 2, 0, 1))
    if k.ndim == 2:
        return k.T
    raise ValueError(f"unexpected kernel rank {k.ndim} in module {module!r}")


def _kernel_to_jax(module: str, w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:
        if module == _TRANSPOSED_CONV and w.shape[2:] == (2, 2):
            return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]
        return np.transpose(w, (2, 3, 1, 0))
    if w.ndim == 2:
        return w.T
    raise ValueError(f"unexpected weight rank {w.ndim} in module {module!r}")


def to_torch(params: Mapping[str, Any],
             batch_stats: Mapping[str, Any] = None) -> Dict[str, torch.Tensor]:
    """flax ``params`` and ``batch_stats`` (nested dicts of arrays) ->
    the port's ``state_dict`` (float32 CPU tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        *mods, name = path
        key = ".".join(mods)
        a = np.array(leaf, np.float32)
        if name == "kernel":
            a = _kernel_to_torch(mods[-1], a)
            name = "weight"
        elif name == "scale":
            name = "weight"
        elif name != "bias":
            raise KeyError(f"unknown flax parameter {'/'.join(path)}")
        sd[f"{key}.{name}"] = torch.from_numpy(np.ascontiguousarray(a))
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, leaf in _flatten(batch_stats or {}):
        *mods, name = path
        key = ".".join(mods)
        if name not in stat_names:
            raise KeyError(f"unknown flax batch statistic {'/'.join(path)}")
        sd[f"{key}.{stat_names[name]}"] = torch.from_numpy(
            np.array(leaf, np.float32))
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _nest(tree: Dict[str, Any], path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def to_jax(state_dict: Mapping[str, torch.Tensor]
           ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of :func:`to_torch`: a ``state_dict`` -> (params,
    batch_stats), nested dicts of float32 numpy arrays."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        mod, name = key.rsplit(".", 1)
        mods = mod.split(".")
        if name == "num_batches_tracked":
            continue
        a = tensor.detach().cpu().to(torch.float32).numpy()
        if name in ("running_mean", "running_var"):
            _nest(batch_stats, mods + ["mean" if name == "running_mean"
                                       else "var"], a.copy())
            continue
        if name == "weight":
            if a.ndim == 1:
                name = "scale"
            else:
                a = _kernel_to_jax(mods[-1], a)
                name = "kernel"
        elif name != "bias":
            raise KeyError(f"unknown state_dict entry {key}")
        _nest(params, mods + [name], np.ascontiguousarray(a))
    return params, batch_stats


# -- whole train states ------------------------------------------------------

def _fields(node) -> tuple:
    return getattr(node, "_fields", ())


def _optax_parts(node, found: Dict[str, Any]) -> Dict[str, Any]:
    """The pieces of an optax state (a tree of named tuples) by their
    field names: MultiSteps' ``mini_step``, ``gradient_step`` and
    ``acc_grads``; Adam's ``count``, ``mu``, ``nu``; SGD momentum's
    ``trace``; the learning-rate schedule's ``count``."""
    fields = _fields(node)
    if "inner_opt_state" in fields:
        found.update(mini_step=int(node.mini_step),
                     gradient_step=int(node.gradient_step),
                     acc_grads=node.acc_grads)
        return _optax_parts(node.inner_opt_state, found)
    if "mu" in fields and "nu" in fields:
        found.update(adam_count=int(node.count), mu=node.mu, nu=node.nu)
    elif "trace" in fields:
        found["trace"] = node.trace
    elif fields == ("count",):
        found["schedule_count"] = int(node.count)
    elif isinstance(node, (tuple, list)) and not fields:
        for child in node:
            _optax_parts(child, found)
    return found


def train_state_to_torch(state, train_step) -> None:
    """Load a JAX ``TrainState`` (``step``, ``params``, ``batch_stats``,
    ``opt_state``, leaves as numpy arrays; the optax state of the JAX
    ``build_optimizer`` for the same ``OptimizationConfig``) into the
    port's ``TrainStep``: its model, its ``Optimizer`` and ``updates``."""
    model, opt = train_step.model, train_step.optimizer
    model.load_state_dict(to_torch(state.params, state.batch_stats))
    found = _optax_parts(state.opt_state, {})
    names = {id(p): n for n, p in model.named_parameters()}
    params = opt.params()
    opt.base.state.clear()
    if "mu" in found:
        mu, nu = to_torch(found["mu"]), to_torch(found["nu"])
        for p in params:
            n = names[id(p)]
            opt.base.state[p] = {
                "step": torch.tensor(float(found["adam_count"])),
                "exp_avg": mu[n].to(p), "exp_avg_sq": nu[n].to(p)}
    elif "trace" in found:
        trace = to_torch(found["trace"])
        for p in params:
            opt.base.state[p] = {"momentum_buffer": trace[names[id(p)]].to(p)}
    opt.updates = found.get("schedule_count", found.get("adam_count", 0))
    micro = found.get("mini_step", 0)
    if micro:
        acc = to_torch(found["acc_grads"])
        opt._mean = [acc[names[id(p)]].to(p) for p in params]
    else:
        opt._mean = None
    opt._micro = micro
    train_step.updates = int(state.step)


def _replace_optax(node, values: Dict[str, Any]):
    """``node`` (an optax state of numpy leaves) with the fields
    :func:`_optax_parts` reads set to ``values``."""
    fields = _fields(node)

    def same(old, new):
        return np.asarray(new, dtype=np.asarray(old).dtype)

    if "inner_opt_state" in fields:
        return node._replace(
            mini_step=same(node.mini_step, values["mini_step"]),
            gradient_step=same(node.gradient_step, values["gradient_step"]),
            acc_grads=values["acc_grads"],
            inner_opt_state=_replace_optax(node.inner_opt_state, values))
    if "mu" in fields and "nu" in fields:
        return node._replace(count=same(node.count, values["adam_count"]),
                             mu=values["mu"], nu=values["nu"])
    if "trace" in fields:
        return node._replace(trace=values["trace"])
    if fields == ("count",):
        return node._replace(count=same(node.count, values["updates"]))
    if isinstance(node, (tuple, list)) and not hasattr(node, "_fields"):
        return type(node)(_replace_optax(c, values) for c in node)
    return node


def train_state_to_jax(train_step, opt_state_template):
    """The inverse of :func:`train_state_to_torch`: the port's
    ``TrainStep`` -> (step, params, batch_stats, opt_state) as numpy, the
    optax state built on ``opt_state_template`` (e.g. the JAX
    ``build_optimizer(...).init(params)``, leaves as numpy arrays)."""
    model, opt = train_step.model, train_step.optimizer
    params, batch_stats = to_jax(model.state_dict())
    names = {id(p): n for n, p in model.named_parameters()}
    plist = opt.params()

    def tree(key):
        """The optimizer's ``key`` state of every parameter (zeros where
        it has none yet), laid out as the flax parameters."""
        def leaf(p):
            v = opt.base.state.get(p, {}).get(key)
            return torch.zeros_like(p) if v is None else v
        return to_jax({names[id(p)]: leaf(p) for p in plist})[0]

    counts = [float(opt.base.state[p]["step"]) for p in plist
              if "step" in opt.base.state.get(p, {})]
    mean = opt._mean or [torch.zeros_like(p) for p in plist]
    values = {
        "mini_step": opt._micro, "gradient_step": opt.updates,
        "acc_grads": to_jax({names[id(p)]: m
                             for p, m in zip(plist, mean)})[0],
        "adam_count": int(counts[0]) if counts else 0,
        "mu": tree("exp_avg"), "nu": tree("exp_avg_sq"),
        "trace": tree("momentum_buffer"), "updates": opt.updates,
    }
    return (train_step.updates, params, batch_stats,
            _replace_optax(opt_state_template, values))
