"""The chip's published peaks and the work a step needs, counted from
the configuration's shapes.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: 989
TFLOP/s in bf16 and fp16, 67 TFLOP/s in float32 outside the tensor
cores, 3.35 TB/s of HBM. A share is stated against them, with the card's
power limit beside it.
"""

from __future__ import annotations

from typing import Dict

BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def peak_flops(use_amp: bool) -> float:
    return BF16_FLOPS_PER_S if use_amp else F32_FLOPS_PER_S


def warp_bytes(batch: int, height: int, width: int, features: int,
               levels: int = 5, elem_bytes: int = 2) -> Dict[str, int]:
    """Bytes each PCL's two-pass warp needs in one forward, by decoder
    level: its input map read once and its output written once (B, h, w,
    c at ``elem_bytes`` each), and theta (B x 6 float32) read once.
    Decoder level i (1 = finest) warps the transposed conv's map, twice
    the size of the level below it (each 2x2 pool drops an odd row or
    column), with f * 2^(i-1) channels."""
    hs, ws = [height], [width]
    for _ in range(levels):
        hs.append(hs[-1] // 2)
        ws.append(ws[-1] // 2)
    return {f"dec{i}": 2 * batch * (2 * hs[i]) * (2 * ws[i])
            * (features << (i - 1)) * elem_bytes + batch * 6 * 4
            for i in range(1, levels + 1)}


def bound_s(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S


def model_flops(init_features: int, batch: int, height: int, width: int,
                train: bool) -> float:
    """FLOPs of one forward (``train``: forward and backward, and the
    loss) of the reference network at these shapes, counted by
    ``torch.utils.flop_counter`` on the meta device, so the count is the
    same whatever implements the step."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.loss import combined_loss
    from benchmark.reference.model import GeometryAwareNet, forward

    with torch.device("meta"):
        model = GeometryAwareNet(init_features)
        b = {"rgb": torch.rand(batch, height, width, 3),
             "intrinsics": torch.rand(batch, 3, 3),
             "k4": torch.rand(batch, 4),
             "depth": torch.rand(batch, height, width, 1)}
    model.train(train)
    counter = FlopCounterMode(display=False)
    with counter, torch.set_grad_enabled(train):
        pred = forward(model, b)
        if train:
            total, _ = combined_loss(
                pred, b["depth"], b["rgb"], b["intrinsics"],
                b["depth"] > 0.1,
                {"si": 1.0, "grad": 0.1, "smooth": 0.001, "reproj": 0.01})
            total.backward()
    return float(counter.get_total_flops())
