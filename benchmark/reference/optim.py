"""The update the configuration states, in plain PyTorch: the learning
rate of optimizer step n (linear warm-up from 0 over the warm-up epochs,
then cosine decay to ``lr_min``), clipping by the global norm, and AdamW
(decoupled weight decay on every parameter; bias-corrected moments;
epsilon outside the square root), float32."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def learning_rate(opt: Dict, steps_per_epoch: int, num_epochs: int,
                  step: int) -> float:
    """The rate of update ``step`` (0-based), computed in float32 as the
    configuration's schedule is."""
    f = np.float32
    warm = int(opt["lr_warmup_epochs"]) * steps_per_epoch
    base = f(opt["learning_rate"])
    if opt["lr_scheduler"] != "cosine":
        raise ValueError("the reference schedules cosine decay only")
    if step < warm:
        frac = f(1.0) - f(min(max(step, 0), warm)) / f(warm)
        return float(f(-base) * frac + base)
    total = max(num_epochs * steps_per_epoch - warm, 1)
    alpha = f(opt["lr_min"] / opt["learning_rate"])
    c = f(min(float(step - warm), float(total)))
    cosine = f(0.5) * (f(1.0) + np.cos(f(np.pi) * c / f(total)))
    return float(base * ((f(1.0) - alpha) * cosine + alpha))


def clip_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the gradients to ``max_norm`` where their global norm is
    above it; returns that norm."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    if float(norm) >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)
    return norm


class AdamW:
    def __init__(self, params: List[torch.Tensor], opt: Dict):
        self.params = params
        self.b1, self.b2 = (float(b) for b in opt["adam_betas"])
        self.eps = float(opt["adam_eps"])
        self.wd = float(opt["weight_decay"])
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = math.sqrt(1.0 - self.b2 ** self.t)
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.mul_(1.0 - lr * self.wd)
            p.sub_(lr * (m / c1) / (v.sqrt() / c2 + self.eps))


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.float()))
            for k, t in tensors.items()}
