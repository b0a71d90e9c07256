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
stands, so no correction is applied. The two differ in training:
flax stores the biased batch variance with momentum 0.99, torch the
unbiased one with momentum 0.01 (ROADMAP.md Queue 1, item 1).
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
