"""FiLM conditioning on camera parameters (port of ``cadepth_tpu.models.film``).

FiLM(F; gamma, beta) = gamma * F + beta, with gamma and beta from an MLP
over the normalized [fx, fy, cx, cy] vector, in float32. The reference
applies its BatchNorm1d only when the batch holds more than one sample,
so one image alone gets a different answer than in a batch; the port
keeps that. In training, a batch of one leaves the statistics as they
are, as in the reference. Under a data-parallel group the batch is the
global one, every data row's samples, as JAX's traced shape is: a rank
holding one sample of a larger batch applies the batch norms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cadepth_tpu_torch.models.layers import BatchNorm1d, Linear


class FiLMLayer(nn.Module):
    """Camera-conditioned feature modulation of an NCHW map."""

    def __init__(self, feature_channels: int, camera_dim: int = 4,
                 hidden_dim: int = 256):
        super().__init__()
        self.fc1 = Linear(camera_dim, 128)
        self.fc2 = Linear(128, hidden_dim)
        self.bn1 = BatchNorm1d(128)
        self.bn2 = BatchNorm1d(hidden_dim)
        self.fc_gamma = Linear(hidden_dim, feature_channels)
        self.fc_beta = Linear(hidden_dim, feature_channels)

    def embed(self, camera_params: torch.Tensor):
        """(gamma, beta), each (B, feature_channels) float32."""
        h = self.fc1(camera_params.float())
        dp = self.bn1.dp
        batched = h.shape[0] * (1 if dp is None else dp.data_size) > 1
        if batched:
            h = self.bn1(h)
        h = self.fc2(F.relu(h))
        if batched:
            h = self.bn2(h)
        h = F.relu(h)
        return self.fc_gamma(h), self.fc_beta(h)

    def forward(self, features: torch.Tensor,
                camera_params: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.embed(camera_params)
        gamma = gamma.to(features.dtype)[:, :, None, None]
        beta = beta.to(features.dtype)[:, :, None, None]
        return gamma * features + beta
