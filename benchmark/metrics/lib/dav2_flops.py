"""A Depth Anything V2 training image's FLOPs: forward, loss and
backward of the reference network (``benchmark/reference/dav2.py``) at
the configuration's widths and size, counted by
``torch.utils.flop_counter`` on the meta device with no recomputation
(attention materialised, each block run once), so the count is the same
whatever implements the step."""

from __future__ import annotations


def model_flops(conf: dict, batch: int) -> float:
    """FLOPs of one training step at ``batch`` images."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.dav2 import DepthAnythingV2Ref
    from benchmark.reference.loss import combined_loss

    c, ref = conf["config"], conf["reference"]
    h, w = c["data"]["input_height"], c["data"]["input_width"]
    with torch.device("meta"):
        model = DepthAnythingV2Ref(
            ref["embed_dim"], ref["depth"], ref["num_heads"], ref["taps"],
            ref["features"], ref["out_channels"], c["model"]["max_depth"])
        b = {"rgb": torch.rand(batch, h, w, 3),
             "intrinsics": torch.rand(batch, 3, 3),
             "depth": torch.rand(batch, h, w, 1)}
    counter = FlopCounterMode(display=False)
    with counter:
        pred = model(b["rgb"])
        total, _ = combined_loss(
            pred, b["depth"], b["rgb"], b["intrinsics"], b["depth"] > 0.1,
            {"si": 1.0, "grad": 0.1, "smooth": 0.001, "reproj": 0.01})
        total.backward()
    return float(counter.get_total_flops())
