"""Host-side geometry file I/O (format parity with the reference).

A copy of ``cadepth_tpu.geometry.io``, which imports no JAX: the port
keeps its own so that it never imports the JAX package. Only the package
name changes.

Binary ray format (`ray_direction_computer.cpp:129-201`, documented at
`ray_direction_computer.h:96-99`):

    [int32 height][int32 width][height*width*3 float32, row-major (u fastest)]

Intrinsics text format: 9 whitespace-separated floats, row-major 3x3
(`ray_direction_computer.cpp:203-231`). Pose text format: 16 floats,
row-major 4x4, validated for rotation orthogonality
(`ray_direction_computer.cpp:233-264`).
"""

from __future__ import annotations

import os

import numpy as np

_HEADER_DTYPE = np.dtype("<i4")
_DATA_DTYPE = np.dtype("<f4")


def save_ray_directions(path: str | os.PathLike, rays: np.ndarray) -> None:
    """Write an (H, W, 3) ray grid in the reference `.bin` format."""
    rays = np.asarray(rays, dtype=np.float32)
    if rays.ndim != 3 or rays.shape[-1] != 3:
        raise ValueError(f"rays must be (H, W, 3), got {rays.shape}")
    h, w, _ = rays.shape
    with open(path, "wb") as f:
        np.array([h, w], dtype=_HEADER_DTYPE).tofile(f)
        rays.astype(_DATA_DTYPE).reshape(h * w, 3).tofile(f)


def load_ray_directions(path: str | os.PathLike) -> np.ndarray:
    """Read a reference-format `rays.bin` into an (H, W, 3) float32 array.

    The reference loads this into (3, H, W) (`sunrgbd_loader.cpp:329-350`);
    we keep NHWC layout.
    """
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=_HEADER_DTYPE, count=2)
        if header.size != 2:
            raise ValueError(f"Truncated ray file header: {path}")
        h, w = int(header[0]), int(header[1])
        if h <= 0 or w <= 0 or h * w > 100_000_000:
            raise ValueError(f"Implausible ray grid dims {h}x{w} in {path}")
        data = np.fromfile(f, dtype=_DATA_DTYPE, count=h * w * 3)
    if data.size != h * w * 3:
        raise ValueError(f"Truncated ray data in {path}")
    return data.reshape(h, w, 3)


def load_intrinsics_txt(path: str | os.PathLike) -> np.ndarray:
    """Load a 3x3 K from a 9-float text file with structure validation.

    Mirrors `RayDirectionComputer::loadIntrinsics`
    (`ray_direction_computer.cpp:203-231`): requires fx, fy > 0 and
    K[2,2] == 1.
    """
    values = np.loadtxt(path, dtype=np.float32).reshape(-1)
    if values.size < 9:
        raise ValueError(f"Intrinsics file {path} has {values.size} values, need 9")
    k = values[:9].reshape(3, 3)
    if k[0, 0] <= 0 or k[1, 1] <= 0:
        raise ValueError(f"Invalid focal lengths in {path}: fx={k[0,0]}, fy={k[1,1]}")
    if abs(k[2, 2] - 1.0) > 1e-5:
        raise ValueError(f"K[2,2] != 1 in {path}: {k[2,2]}")
    return k


def load_pose_txt(path: str | os.PathLike, check_orthogonal: bool = True) -> np.ndarray:
    """Load a 4x4 pose from a 16-float text file.

    Mirrors `RayDirectionComputer::loadPose` (`ray_direction_computer.cpp:233-264`)
    including the rotation-orthogonality check (R @ R.T ~ I).
    """
    values = np.loadtxt(path, dtype=np.float32).reshape(-1)
    if values.size < 16:
        raise ValueError(f"Pose file {path} has {values.size} values, need 16")
    pose = values[:16].reshape(4, 4)
    if check_orthogonal:
        rot = pose[:3, :3]
        err = np.abs(rot @ rot.T - np.eye(3, dtype=np.float32)).max()
        if err > 1e-3:
            raise ValueError(f"Pose rotation not orthogonal in {path} (max err {err:.2e})")
    return pose
