"""The bytes the training batch norms of a step need, counted from the
network's own shapes, as ``roofline.model_flops`` counts its FLOPs.

The maps are those the reference network (``benchmark/reference/
model.py``) hands its batch norms in one training forward at the
configuration's batch and input size, seen by hooks on the meta device:
22 maps of the geometry-aware network, two in each of its eleven blocks
(FiLM's batch norms over (B, C) vectors are left out). Each map needs
its input read once and its output written once forward, and the
output's gradient and the input read once and the input's gradient
written once backward: with maps of ``elem_bytes`` in and out, 5 x
``elem_bytes`` bytes an element, 10 in bf16. The count is the same
whatever implements the norms, and counts a block recomputed under
remat once.

The reference is the full geometry-aware network with batch norms over
whole maps, so :func:`norm_bytes` counts nothing (None) for another
architecture, variant or norm, or for maps cut into spatial bands.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def norm_maps(batch: int, height: int, width: int, features: int
              ) -> List[Tuple[int, int, int, int]]:
    """The (B, C, H, W) shapes of the maps the reference network's batch
    norms take in one training forward, in the order it calls them."""
    import torch

    from benchmark.reference.model import GeometryAwareNet, Norm, forward

    with torch.device("meta"):
        model = GeometryAwareNet(features)
        b = {"rgb": torch.rand(batch, height, width, 3),
             "intrinsics": torch.rand(batch, 3, 3),
             "k4": torch.rand(batch, 4)}
    shapes = []

    def seen(_module, args):
        if args[0].dim() == 4:
            shapes.append(tuple(args[0].shape))

    hooks = [m.register_forward_pre_hook(seen) for m in model.modules()
             if isinstance(m, Norm)]
    try:
        with torch.no_grad():
            forward(model.train(), b)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def norm_bytes(config: dict, elem_bytes: int) -> Optional[int]:
    """Bytes the step's training norms need, forward and backward, for
    the port's configuration ``config`` (its dict); None where the
    reference network is not the configuration's (module docstring)."""
    model = config.get("model", {})
    hardware = config.get("hardware", {})
    if (model.get("architecture", "baseline_unet") != "geometry_aware"
            or model.get("variant", "full") != "full"
            or model.get("norm", "batch") != "batch"
            or int(hardware.get("spatial_parallel", 1)) > 1):
        return None
    maps = norm_maps(int(config["training"]["batch_size"]),
                     int(config["data"]["input_height"]),
                     int(config["data"]["input_width"]),
                     int(model["init_features"]))
    elements = sum(b * c * h * w for b, c, h, w in maps)
    return elements * 5 * elem_bytes
