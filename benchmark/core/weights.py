"""Seeded weights: one ``state_dict`` that both the port and the
reference load.

All of it is drawn on the device from one ``torch.Generator`` seeded by
the run's seed, in one call: a standard normal vector as long as every
parameter and buffer together, cut into the leaves in the reference
model's order and scaled by the leaf's kind. Convolutions and dense
layers: He normal (std sqrt(2 / fan_in)), biases 0.01 N; batch norms:
scale 1 + 0.1 N, shift 0.1 N, running mean 0.05 N, running variance
1 + 0.1 |N|; FiLM's heads: 0.01 N weights, gamma's bias 1 + 0.01 N;
the PCL's head: weights 0.01 N / sqrt(fan_in), bias [1, 1, 0, 0, 0, 0] +
0.02 N, so each warp rotates, shears and shifts a little (|rot| a few
hundredths of a radian, inside the two-pass warp's sub-pixel bound).
The depth head is He too: at five times He about 2 % of a training
batch's depths fell under 0.1 m, where the loss's logarithm turns
bf16 rounding into gaps of several percent. Each decoder level's first
convolution reads the upsampled map from below at a quarter of He
(``DEEP_PATH``) and the skip at He, so the output leans on the skips as
a trained U-Net's does: at full scale the random network's training
forward is chaotic, and bf16 rounding moved its depths by 3-26 % of
their own variation, as far as float8 rounding (41-68 %) on some seeds
(`PERF.md`).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.model import (PCL, FiLM, GeometryAwareNet, Norm,
                                       UpConv)

# the words of the generator's seed, so weights and scenes draw apart
WEIGHTS_STREAM = 0x5745
# the scale a decoder level's first convolution reads the level below at
DEEP_PATH = 0.25


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + stream) % (2 ** 63))
    return g


def layout(init_features: int) -> GeometryAwareNet:
    """The reference network on the meta device: the leaves' names and
    shapes, no storage."""
    with torch.device("meta"):
        return GeometryAwareNet(init_features)


def _leaves(model: torch.nn.Module):
    """(key, module, parent, attribute name, leaf name) of every entry of
    ``model.state_dict()``, in its order."""
    mods = dict(model.named_modules())
    for name, mod in mods.items():
        parent_name, _, attr = name.rpartition(".")
        parent = mods[parent_name] if name else None
        for leaf, _ in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            yield f"{name}.{leaf}" if name else leaf, mod, parent, attr, leaf


@torch.no_grad()
def seeded_state(model: GeometryAwareNet, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """The seeded ``state_dict`` of ``model``'s layout, float32 on
    ``device`` (``num_batches_tracked`` 0)."""
    layout = model.state_dict()
    leaves = {k: rest for k, *rest in _leaves(model)}
    floats = [k for k, t in layout.items() if t.is_floating_point()]
    noise = torch.randn(sum(layout[k].numel() for k in floats),
                        generator=generator(seed, WEIGHTS_STREAM, device),
                        device=device)
    out, at = {}, 0
    for key, t in layout.items():
        if not t.is_floating_point():
            out[key] = torch.zeros_like(t, device=device)
            continue
        z = noise[at:at + t.numel()].view(t.shape)
        at += t.numel()
        out[key] = _scaled(z, *leaves[key])
        if key.startswith("dec") and key.endswith(".conv.conv1.weight"):
            # the decoder reads its upsampled half (after the skip's) at a
            # quarter of He
            out[key][:, out[key].shape[1] // 2:] *= DEEP_PATH
    return out


def _scaled(z, mod, parent, attr, leaf):
    if isinstance(mod, Norm):
        return {"weight": 1.0 + 0.1 * z, "bias": 0.1 * z,
                "running_mean": 0.05 * z,
                "running_var": 1.0 + 0.1 * z.abs()}[leaf]
    if isinstance(parent, FiLM) and attr in ("fc_gamma", "fc_beta"):
        if leaf == "weight":
            return 0.01 * z
        return (1.0 if attr == "fc_gamma" else 0.0) + 0.01 * z
    if isinstance(parent, PCL) and attr == "fc_transform":
        if leaf == "weight":
            return 0.01 * z / math.sqrt(z.shape[1])
        return z.new_tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.0]) + 0.02 * z
    if leaf == "bias":
        return 0.01 * z
    if isinstance(mod, UpConv):
        # each output pixel reads one tap of every input channel
        return z / math.sqrt(z.shape[0])
    return z * math.sqrt(2.0 / z[0].numel())
