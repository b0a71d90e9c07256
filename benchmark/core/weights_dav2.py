"""Seeded weights of Depth Anything V2 (metric): one ``state_dict`` that
the port and the reference (``benchmark/reference/dav2.py``) both load.

Drawn as ``weights.py`` draws the geometry-aware network's: one standard
normal vector from the run's seed on the device, cut into the leaves in
the reference's order and scaled by the leaf's kind. Linear layers and
convolutions that read a normalised or linear input: lecun normal (std
sqrt(1 / fan_in)); those that read a ReLU's output (the fusion blocks'
residual units, the depth's 3x3 and 1x1 after ReLUs): He normal (std
sqrt(2 / fan_in)); the transposed convolutions, where each output pixel
reads one tap of every input channel: std sqrt(1 / in channels); biases
0.01 N. LayerNorms: scale 1 + 0.1 N, shift 0.1 N; LayerScales
``LAYER_SCALE`` (1 + 0.1 N), the size trained DINOv2 blocks have; cls
token and position table 0.02 N. The depth's last 1x1 conv reads its 32
maps at ``DEPTH_HEAD`` of He, so that the sigmoid works near its linear
part (depths of 10 +- a few m): where it saturates, depths under 0.1 m
leave the loss's masks and its logarithm turns rounding into gaps of
whole percent (``weights.py``'s head had the same cure).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.core.weights import WEIGHTS_STREAM, generator
from benchmark.reference.dav2 import (Conv, Dense, DepthAnythingV2Ref,
                                      LayerNorm, LayerScale, RCU, Scratch,
                                      ViT)

LAYER_SCALE = 0.1
DEPTH_HEAD = 0.1


def layout(conf: Dict) -> DepthAnythingV2Ref:
    """The reference network at the widths of configuration file ``conf``
    (its ``reference`` block) on the meta device: the leaves' names and
    shapes, no storage."""
    ref = conf["reference"]
    with torch.device("meta"):
        return DepthAnythingV2Ref(
            ref["embed_dim"], ref["depth"], ref["num_heads"], ref["taps"],
            ref["features"], ref["out_channels"],
            float(conf["config"]["model"]["max_depth"]))


def _kinds(model: torch.nn.Module) -> Dict[str, str]:
    """The draw of every leaf of ``model.state_dict()``, by key."""
    kinds = {}
    relu_fed = set()
    for name, mod in model.named_modules():
        if isinstance(mod, RCU):
            relu_fed.update({f"{name}.conv1", f"{name}.conv2"})
        if isinstance(mod, Scratch):
            relu_fed.add(f"{name}.output_conv2.2")
    for name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            key = f"{name}.{leaf}" if name else leaf
            if isinstance(mod, LayerNorm):
                kind = "ln_" + leaf
            elif isinstance(mod, LayerScale):
                kind = "layer_scale"
            elif isinstance(mod, ViT):
                kind = "embedding"
            elif leaf == "bias":
                kind = "bias"
            elif isinstance(mod, Conv) and mod.transposed:
                kind = "transposed"
            elif name.endswith("output_conv2.2"):
                kind = "depth"
            elif name in relu_fed:
                kind = "he"
            elif isinstance(mod, (Conv, Dense)):
                kind = "lecun"
            else:
                raise KeyError(f"no draw for {key}")
            kinds[key] = kind
    return kinds


@torch.no_grad()
def seeded_state(model: DepthAnythingV2Ref, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """The seeded ``state_dict`` of ``model``'s layout, float32 on
    ``device``."""
    shapes = model.state_dict()
    kinds = _kinds(model)
    noise = torch.randn(sum(t.numel() for t in shapes.values()),
                        generator=generator(seed, WEIGHTS_STREAM, device),
                        device=device)
    out, at = {}, 0
    for key, t in shapes.items():
        z = noise[at:at + t.numel()].view(t.shape)
        at += t.numel()
        out[key] = _scaled(z, kinds[key])
    return out


def _scaled(z: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "ln_weight":
        return 1.0 + 0.1 * z
    if kind == "ln_bias":
        return 0.1 * z
    if kind == "layer_scale":
        return LAYER_SCALE * (1.0 + 0.1 * z)
    if kind in ("embedding", "bias"):
        return (0.02 if kind == "embedding" else 0.01) * z
    if kind == "transposed":
        return z / math.sqrt(z.shape[0])
    fan_in = z[0].numel()
    if kind == "lecun":
        return z / math.sqrt(fan_in)
    he = z * math.sqrt(2.0 / fan_in)
    return DEPTH_HEAD * he if kind == "depth" else he
