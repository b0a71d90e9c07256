"""Per-pixel camera ray directions (port of ``cadepth_tpu.geometry.rays``).

r(u, v) = normalize([(u - cx) / fx, (v - cy) / fy, 1]), computed on the
device of K. Layout is NHWC: (H, W, 3) and (B, H, W, 3).
"""

from __future__ import annotations

import torch


def ray_grid(intrinsics: torch.Tensor, height: int, width: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Unit ray direction for every pixel of an (height, width) image.

    Args:
      intrinsics: (3, 3) camera matrix K.

    Returns:
      (height, width, 3) unit rays in the camera frame.
    """
    return ray_grid_batch(intrinsics[None], height, width, dtype)[0]


def ray_grid_batch(intrinsics: torch.Tensor, height: int, width: int,
                   dtype: torch.dtype = torch.float32,
                   row0: int = 0) -> torch.Tensor:
    """Batched :func:`ray_grid`: (B, 3, 3) -> (B, height, width, 3); with
    ``row0``, the rays of the image rows ``row0 .. row0 + height - 1`` (a
    band of a taller image)."""
    k = intrinsics.to(torch.float32)
    fx = k[:, 0, 0, None, None]
    fy = k[:, 1, 1, None, None]
    cx = k[:, 0, 2, None, None]
    cy = k[:, 1, 2, None, None]
    u = torch.arange(width, dtype=torch.float32, device=k.device)[None, None, :]
    v = torch.arange(row0, row0 + height, dtype=torch.float32,
                     device=k.device)[None, :, None]
    x = (u - cx) / fx
    y = (v - cy) / fy
    x, y = torch.broadcast_tensors(x, y)
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    inv_norm = torch.rsqrt(torch.sum(rays * rays, dim=-1, keepdim=True))
    return (rays * inv_norm).to(dtype)


def rays_to_world(rays: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Rotate camera-frame rays into the world frame, r_world = R @ r, and
    re-normalize with ``rsqrt(max(|w|^2, 1e-12))``.

    Args:
      rays: (..., 3) camera-frame rays.
      pose: (4, 4) or (3, 3) camera-to-world transform; only the rotation
        block is used (rays are directions).

    Returns:
      (..., 3) world-frame unit rays.

    The product is three multiply-adds per component in the rays' dtype
    (JAX's einsum runs at ``precision="highest"``): no matrix unit, so
    TF32 settings never reach it.
    """
    rot = pose[:3, :3].to(device=rays.device, dtype=rays.dtype)
    world = (rays[..., 0, None] * rot[:, 0] + rays[..., 1, None] * rot[:, 1]
             + rays[..., 2, None] * rot[:, 2])
    inv_norm = torch.rsqrt(torch.clamp_min(
        torch.sum(world * world, dim=-1, keepdim=True), 1e-12))
    return world * inv_norm


def ray_depth(ray: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Depth of ``point`` along the unit ``ray``: their dot product over
    the last axis."""
    return torch.sum(ray * point, dim=-1)
