"""The precision the reference computes its convolutions and dense layers
in: float32 (the reference), or float8 e4m3 with one scale a tensor (the
control, the step below the configuration's bfloat16 that would tempt a
faster program).

In float8 every tensor that the configuration holds in bfloat16 is held
in e4m3 instead (scaled so that the tensor's largest magnitude maps to
e4m3's largest, 448): the inputs, weights and outputs of every
convolution and gated dense layer, and the maps between them (the batch
norms' outputs, FiLM's, the attention gates' products, the warps'); the
products themselves accumulate in float32, as the batch norms' statistics
do. The gradient that reaches each product's output is rounded the same
way, so the backward computes on float8 operands too.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming gradient to
    float8."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad)


class Precision:
    """``name`` "float32" or "float8"."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    @property
    def low(self) -> bool:
        return self.name == "float8"

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """A product's input or weight as this precision holds it (the
        rounding passes the gradient straight through)."""
        if not self.low:
            return x
        return x + (_fp8(x) - x).detach()

    def result(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output as this precision holds it; in float8 its
        gradient is rounded too."""
        if not self.low:
            return y
        y = self.operand(y)
        return _RoundGrad.apply(y) if y.requires_grad else y


FLOAT32 = Precision("float32")
