"""Perspective Correction Layers (port of ``cadepth_tpu.models.pcl``).

A 6-parameter head over [mean-pooled features; normalized K] predicts an
affine theta per sample, and the feature map is warped by it. The head
starts at the identity (zero kernel, bias [1, 1, 0, 0, 0, 0]). As in the
reference's decoder, the layer takes no ray directions. The warp modes
(``warp_mode``, the config's ``model.pcl_warp``):

* "two_pass" and "pallas": the two-pass warp (``ops/two_pass_warp.py``,
  CUDA kernels on the card);
* "fused": the banded warp (``ops/fused_warp.py``, kernels of its own);
* "gather": ``grid_sample(affine_grid(theta))`` (``ops/grid_sample.py``,
  plain PyTorch, as JAX leaves it to XLA);
* "separable": the scale-and-translate warp of
  ``ops/affine_warp.py: separable_affine_warp`` (rotation and shear
  dropped), plain PyTorch products;
* "auto": the two-pass warp, replaced by the gather warp's result when
  the batch's max |rotation| reaches ``DEFAULT_ROT_BOUND``. JAX selects with
  ``lax.cond`` on the device; here ``torch.where`` selects on the device
  too (no host sync), so the gather warp runs on every call.

Every mode is differentiable in the features and theta while grad mode
is on. :class:`Perspective3DTransformer` is the reference's ray-displaced
warp (``grid_sample`` with border padding, ``align_corners=True``).

On bands (spatial parallelism, ``parallel/spatial.py``) a warp reads
rows of other bands, so the layer gathers its map along H. The two-pass
modes ("two_pass", "pallas") then warp only this rank's output rows, a
window of the kernels (``ops/two_pass_warp.py``); the other modes warp
the whole gathered map on every rank of the space row and keep the
band, which is exact at S times the warp's work. The head's pooled mean
is the whole image's, so every rank of the row predicts the same theta.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cadepth_tpu_torch.models.layers import Conv2d, Linear, recomputing
from cadepth_tpu_torch.ops.affine_warp import separable_affine_warp
from cadepth_tpu_torch.ops.fused_warp import fused_warp
from cadepth_tpu_torch.ops.grid_sample import gather_affine_warp, grid_sample
from cadepth_tpu_torch.ops.two_pass_warp import two_pass_warp
from cadepth_tpu_torch.parallel import spatial

# Rotation magnitude (rad) under which the two-pass warp's kernel
# displacement (<= |tan rot| px) stays sub-pixel: "auto" mode's guard,
# and what pcl_max_rot is read against.
DEFAULT_ROT_BOUND = 0.05

# The warp each mode calls ("auto" calls the two-pass warp and the gather
# warp).
WARPS = {"two_pass": two_pass_warp, "pallas": two_pass_warp,
         "fused": fused_warp, "gather": gather_affine_warp,
         "separable": separable_affine_warp, "auto": two_pass_warp}


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
        if warp_mode not in WARPS:
            raise ValueError(f"Unknown warp_mode: {warp_mode}")
        self.warp_mode = warp_mode
        self.loc_fc1 = Linear(feature_channels + camera_dim, hidden_dim)
        self.loc_fc2 = Linear(hidden_dim, hidden_dim)
        self.fc_transform = Linear(hidden_dim, 6)
        # The warp function; chip_smoke.py swaps in the plain version to
        # hold the served depths against it on the card.
        self.warp = WARPS[warp_mode]

    def forward(self, features: torch.Tensor, camera_intrinsics: torch.Tensor,
                intermediates: Optional[Dict[str, List[torch.Tensor]]] = None
                ) -> torch.Tensor:
        """features (B, C, H, W) channels_last, K4 (B, 4) normalized.

        When ``intermediates`` is a dict, appends this layer's max
        |predicted rotation| to its ``"pcl_max_rot"`` list (once: not again
        when a checkpointed block is recomputed).
        """
        space = spatial.bands()
        pooled = (features.mean(dim=(2, 3)) if space is None
                  else space.mean_hw(features)).float()
        loc_in = torch.cat([pooled, camera_intrinsics.float()], dim=-1)
        h = F.relu(self.loc_fc1(loc_in))
        h = F.relu(self.loc_fc2(h))
        params = self.fc_transform(h)
        theta = _build_affine_matrix(params)
        # max |rotation| is read, never differentiated
        rot = params[:, 4].detach()
        if intermediates is not None and not recomputing():
            intermediates.setdefault("pcl_max_rot", []).append(
                rot.abs().max())
        x = features.permute(0, 2, 3, 1)
        if space is None:
            return self._warp(x, theta, rot).permute(0, 3, 1, 2)
        whole = space.gather(x, 1)
        if self.warp_mode in ("two_pass", "pallas"):
            rows = x.shape[1]
            out = self.warp(whole, theta, "zeros", False,
                            space.row0(rows), rows)
        else:
            out = space.band(self._warp(whole, theta, rot), 1)
        return out.permute(0, 3, 1, 2)

    def _warp(self, x: torch.Tensor, theta: torch.Tensor,
              rot: torch.Tensor) -> torch.Tensor:
        out = self.warp(x, theta, "zeros", False)
        if self.warp_mode == "auto":
            in_bound = rot.abs().max() < DEFAULT_ROT_BOUND
            out = torch.where(in_bound, out,
                              gather_affine_warp(x, theta, "zeros", False))
        return out


class Perspective3DTransformer(nn.Module):
    """Ray-displaced warping with per-pixel depth offsets: a 1x1 conv and
    tanh give a depth offset per pixel, a small head over [mean-pooled
    features; K] a translation (tx, ty, tz; ``models/factory.init_weights``
    starts its last layer at zero); the map is resampled at
    ``offset * ray_xy + t_xy``, normalised by half the size, with border
    padding and ``align_corners=True``."""

    def __init__(self, feature_channels: int, camera_dim: int = 4):
        super().__init__()
        self.depth_pred = Conv2d(feature_channels, 1, 1, dtype=torch.float32)
        self.loc_fc1 = Linear(feature_channels + camera_dim, 128)
        self.loc_fc2 = Linear(128, 3)

    def forward(self, features: torch.Tensor, camera_intrinsics: torch.Tensor,
                ray_directions: torch.Tensor) -> torch.Tensor:
        """features (B, C, H, W) and rays (B, 3, H, W), NCHW; K4 (B, 4)."""
        h, w = features.shape[2], features.shape[3]
        depth_offset = torch.tanh(self.depth_pred(features.float()))
        pooled = features.mean(dim=(2, 3)).float()
        loc_in = torch.cat([pooled, camera_intrinsics.float()], dim=-1)
        translation = self.loc_fc2(F.relu(self.loc_fc1(loc_in)))  # (B, 3)
        rays = ray_directions.float()
        t = translation[:, :, None, None]
        dx = depth_offset * rays[:, 0:1] + t[:, 0:1]
        dy = depth_offset * rays[:, 1:2] + t[:, 1:2]
        # divide by device tensors: CUDA divides by a Python float through
        # its reciprocal
        grid = torch.cat([dx / dx.new_tensor(w / 2.0),
                          dy / dy.new_tensor(h / 2.0)], dim=1)
        out = grid_sample(features.permute(0, 2, 3, 1),
                          grid.permute(0, 2, 3, 1), "border", True)
        return out.permute(0, 3, 1, 2)
