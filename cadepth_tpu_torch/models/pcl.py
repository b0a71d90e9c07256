"""Perspective Correction Layer (port of ``cadepth_tpu.models.pcl``).

A 6-parameter head over [mean-pooled features; normalized K] predicts an
affine theta per sample, and the feature map is warped by it with the
two-pass warp (``ops/two_pass_warp.py``) or, for ``warp_mode="fused"``,
the banded warp (``ops/fused_warp.py``), differentiable in both the
features and theta while grad mode is on. The head starts at the
identity (zero kernel, bias [1, 1, 0, 0, 0, 0]). As in the reference's
decoder, the layer takes no ray directions.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cadepth_tpu_torch.models.layers import Linear
from cadepth_tpu_torch.ops.fused_warp import fused_warp
from cadepth_tpu_torch.ops.two_pass_warp import two_pass_warp

# Rotation magnitude (rad) under which the two-pass warp's kernel
# displacement (<= |tan rot| px) stays sub-pixel; pcl_max_rot is read
# against it.
DEFAULT_ROT_BOUND = 0.05

# JAX warp modes that compute the two-pass function; both go to its
# kernels. "fused" is the banded function (exact only inside
# ops/fused_warp.fused_warp_theta_ok), with kernels of its own.
TWO_PASS_MODES = ("two_pass", "pallas")
UNPORTED_MODES = ("gather", "auto", "separable")


def _build_affine_matrix(params: torch.Tensor) -> torch.Tensor:
    """(B, 6) [sx, sy, tx, ty, rot, shear] -> (B, 2, 3) theta:
    [[sx cos r, -sin r + shear, tx], [sin r, sy cos r, ty]]."""
    sx, sy = params[:, 0], params[:, 1]
    tx, ty = params[:, 2], params[:, 3]
    rot, shear = params[:, 4], params[:, 5]
    cos_r = torch.cos(rot)
    sin_r = torch.sin(rot)
    row0 = torch.stack([sx * cos_r, -sin_r + shear, tx], dim=-1)
    row1 = torch.stack([sin_r, sy * cos_r, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


class PerspectiveCorrectionLayer(nn.Module):
    """Learned affine re-sampling of an NCHW channels_last map, conditioned on K."""

    def __init__(self, feature_channels: int, camera_dim: int = 4,
                 hidden_dim: int = 128, warp_mode: str = "two_pass"):
        super().__init__()
        if warp_mode in UNPORTED_MODES:
            raise NotImplementedError(
                f"pcl_warp={warp_mode!r} is not ported yet "
                "(ROADMAP.md Queue 1, item 2; Queue 2)")
        if warp_mode not in TWO_PASS_MODES + ("fused",):
            raise ValueError(f"Unknown warp_mode: {warp_mode}")
        self.loc_fc1 = Linear(feature_channels + camera_dim, hidden_dim)
        self.loc_fc2 = Linear(hidden_dim, hidden_dim)
        self.fc_transform = Linear(hidden_dim, 6)
        # The warp function; chip_smoke.py swaps in the plain version to
        # hold the served depths against it on the card.
        self.warp = fused_warp if warp_mode == "fused" else two_pass_warp

    def forward(self, features: torch.Tensor, camera_intrinsics: torch.Tensor,
                intermediates: Optional[Dict[str, List[torch.Tensor]]] = None
                ) -> torch.Tensor:
        """features (B, C, H, W) channels_last, K4 (B, 4) normalized.

        When ``intermediates`` is a dict, appends this layer's max
        |predicted rotation| to its ``"pcl_max_rot"`` list.
        """
        pooled = features.mean(dim=(2, 3)).float()
        loc_in = torch.cat([pooled, camera_intrinsics.float()], dim=-1)
        h = F.relu(self.loc_fc1(loc_in))
        h = F.relu(self.loc_fc2(h))
        params = self.fc_transform(h)
        theta = _build_affine_matrix(params)
        if intermediates is not None:
            intermediates.setdefault("pcl_max_rot", []).append(
                params[:, 4].abs().max())
        out = self.warp(features.permute(0, 2, 3, 1), theta, "zeros", False)
        return out.permute(0, 3, 1, 2)
