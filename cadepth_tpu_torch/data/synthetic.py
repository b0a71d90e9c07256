"""Synthetic SUN RGB-D fixture generator.

A copy of ``cadepth_tpu.data.synthetic``, which imports no JAX: the port
keeps its own so that it never imports the JAX package. Only the package
name changes.

The reference has no hermetic data fixtures — its loader test requires
the real 10,335-image dataset on disk (`tests/test_dataloader.cpp`).
This generator builds a tiny fake SUN RGB-D tree (same directory layout,
file formats, and manifest schema) so every data-path test runs
anywhere, and benchmarks can synthesize arbitrary dataset sizes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_SENSOR_SPECS = {
    # sensor: (rgb_w, rgb_h, depth_w, depth_h) — kv2 mismatched like the
    # real dataset (manifest template: kv2 RGB 1920x1080, depth 512x424;
    # scaled down here for test speed).
    "kv1": (64, 48, 64, 48),
    "kv2": (96, 54, 64, 42),
    "realsense": (64, 48, 64, 48),
    "xtion": (64, 48, 64, 48),
}


def _structured_scene(rng, rgb_w: int, rgb_h: int, fx: float, fy: float):
    """A learnable RGB-D pair: planar floor + boxes, RGB correlated with
    depth and surface identity (so a depth net can actually converge —
    random-noise fixtures have no learnable signal)."""
    u, v = np.meshgrid(np.arange(rgb_w, dtype=np.float32),
                       np.arange(rgb_h, dtype=np.float32))
    # background: tilted plane receding with v (floor-like), 2-9m
    base = 2.0 + 6.0 * (1.0 - v / rgb_h) + 0.5 * (u / rgb_w)
    depth = base.copy()
    color = np.zeros((rgb_h, rgb_w, 3), np.float32)
    color[..., 0] = 0.2 + 0.05 * np.sin(u / 7.0)
    color[..., 1] = 0.3 + 0.04 * np.cos(v / 9.0)
    color[..., 2] = 0.5
    # boxes at random depths; each box gets a color keyed to its depth
    for _ in range(int(rng.integers(3, 7))):
        bw = int(rng.integers(rgb_w // 8, rgb_w // 3))
        bh = int(rng.integers(rgb_h // 8, rgb_h // 3))
        x0 = int(rng.integers(0, rgb_w - bw))
        y0 = int(rng.integers(0, rgb_h - bh))
        d = float(rng.uniform(0.8, 8.5))
        region = depth[y0:y0 + bh, x0:x0 + bw]
        mask = region > d  # boxes occlude what's behind them
        region[mask] = d
        shade = d / 10.0
        color[y0:y0 + bh, x0:x0 + bw][mask] = [
            0.9 - 0.7 * shade, 0.2 + 0.6 * shade, 0.4 + 0.3 * shade]
    # mild shading by depth + noise
    color *= (1.1 - depth[..., None] / 15.0)
    color += rng.normal(0, 0.02, color.shape).astype(np.float32)
    rgb = (np.clip(color, 0, 1) * 255).astype(np.uint8)
    depth_mm = (depth * 1000).astype(np.uint16)
    holes = rng.uniform(size=depth.shape) < 0.02
    depth_mm[holes] = 0
    return rgb, depth_mm


def _projective_scene(rng, rgb_w: int, rgb_h: int, fx: float, fy: float,
                      cx: float, cy: float):
    """A camera-aware benchmark scene: 3D boxes of KNOWN physical sizes
    projected through K. Apparent size = f * size / Z, so depth is only
    recoverable by combining appearance with the intrinsics — monocular
    cues alone are ambiguous across cameras. This is the property the
    reference's camera-conditioned models exist to exploit.

    Color encodes the physical size class (the learnable cue)."""
    depth = np.full((rgb_h, rgb_w), 10.0, np.float32)  # far background
    color = np.zeros((rgb_h, rgb_w, 3), np.float32)
    color[...] = [0.15, 0.15, 0.2]
    # size classes with distinct colors
    classes = [(0.4, [0.9, 0.2, 0.2]), (0.8, [0.2, 0.9, 0.2]),
               (1.6, [0.2, 0.3, 0.9])]
    for _ in range(int(rng.integers(6, 12))):
        size, col = classes[int(rng.integers(0, len(classes)))]
        z = float(rng.uniform(1.5, 9.0))
        # project a size x size square at depth z, random image position
        pw = max(int(fx * size / z), 2)
        ph = max(int(fy * size / z), 2)
        if pw >= rgb_w or ph >= rgb_h:
            continue
        x0 = int(rng.integers(0, rgb_w - pw))
        y0 = int(rng.integers(0, rgb_h - ph))
        region = depth[y0:y0 + ph, x0:x0 + pw]
        mask = region > z
        region[mask] = z
        color[y0:y0 + ph, x0:x0 + pw][mask] = col
    color += rng.normal(0, 0.02, color.shape).astype(np.float32)
    rgb = (np.clip(color, 0, 1) * 255).astype(np.uint8)
    depth_mm = (depth * 1000).astype(np.uint16)
    return rgb, depth_mm


def generate_synthetic_dataset(
    root: str,
    images_per_sensor: int = 2,
    seed: int = 0,
    sensors: tuple = ("kv1", "kv2", "realsense", "xtion"),
    with_rays: bool = False,
    with_extrinsics: bool = True,
    sensor_specs: Optional[Dict[str, tuple]] = None,
    structured: bool = False,
    projective: bool = False,
    focal_range: tuple = (0.8, 1.2),
) -> str:
    """Create a fake SUN RGB-D tree + manifest under `root`.

    Layout per image dir (mirrors what `validate_sunrgbd.cpp` expects):
        <root>/sunrgbd/<sensor>/scene_<i>/{image/rgb.png, depth/depth.png,
        intrinsics.txt, scene.txt[, extrinsics/pose.txt][, rays.bin]}

    Returns the manifest path.
    """
    import cv2

    from cadepth_tpu_torch.geometry.io import save_ray_directions

    rng = np.random.default_rng(seed)
    root_path = Path(root)
    data_dir = root_path / "sunrgbd"
    specs = dict(_SENSOR_SPECS)
    if sensor_specs:
        specs.update(sensor_specs)
    images = []
    sensor_counts: Dict[str, int] = {}
    for sensor in sensors:
        rgb_w, rgb_h, d_w, d_h = specs[sensor]
        for i in range(images_per_sensor):
            img_dir = data_dir / sensor / f"scene_{i:04d}"
            (img_dir / "image").mkdir(parents=True, exist_ok=True)
            (img_dir / "depth").mkdir(parents=True, exist_ok=True)

            fx = float(rng.uniform(*focal_range)) * rgb_w
            fy = float(rng.uniform(*focal_range)) * rgb_h
            cx, cy = rgb_w / 2.0, rgb_h / 2.0

            if projective:
                rgb, depth_full = _projective_scene(rng, rgb_w, rgb_h,
                                                    fx, fy, cx, cy)
                depth_mm = cv2.resize(depth_full, (d_w, d_h),
                                      interpolation=cv2.INTER_NEAREST)
            elif structured:
                rgb, depth_full = _structured_scene(rng, rgb_w, rgb_h, fx, fy)
                depth_mm = cv2.resize(depth_full, (d_w, d_h),
                                      interpolation=cv2.INTER_NEAREST)
            else:
                rgb = rng.integers(0, 256, size=(rgb_h, rgb_w, 3), dtype=np.uint8)
                # 16-bit depth in millimeters, 500-9500mm plus some holes.
                depth_mm = rng.integers(500, 9500,
                                        size=(d_h, d_w)).astype(np.uint16)
                holes = rng.uniform(size=(d_h, d_w)) < 0.05
                depth_mm[holes] = 0
            cv2.imwrite(str(img_dir / "image" / "rgb.png"),
                        cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
                        if (structured or projective) else rgb)
            cv2.imwrite(str(img_dir / "depth" / "depth.png"), depth_mm)
            (img_dir / "intrinsics.txt").write_text(
                f"{fx} 0 {cx} 0 {fy} {cy} 0 0 1\n")
            (img_dir / "scene.txt").write_text("bedroom\n")

            if with_extrinsics:
                ext_dir = img_dir / "extrinsics"
                ext_dir.mkdir(exist_ok=True)
                theta = float(rng.uniform(-0.2, 0.2))
                rot = np.array(
                    [[np.cos(theta), -np.sin(theta), 0],
                     [np.sin(theta), np.cos(theta), 0],
                     [0, 0, 1]], dtype=np.float32)
                (ext_dir / "pose.txt").write_text(
                    "\n".join(" ".join(f"{v:.6f}" for v in row) for row in rot))

            if with_rays:
                k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
                u, v = np.meshgrid(np.arange(rgb_w), np.arange(rgb_h))
                x = (u - cx) / fx
                y = (v - cy) / fy
                z = np.ones_like(x)
                rays = np.stack([x, y, z], axis=-1)
                rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
                save_ray_directions(img_dir / "rays.bin", rays.astype(np.float32))

            sensor_counts[sensor] = sensor_counts.get(sensor, 0) + 1
            images.append({
                "path": str(img_dir),
                "sensor_type": sensor,
                "has_intrinsics": True,
                "has_rgb": True,
                "has_depth": True,
                "has_extrinsics": with_extrinsics,
                "has_scene_info": True,
                "rgb_resolution": [rgb_w, rgb_h],
                "depth_resolution": [d_w, d_h],
                "valid": True,
            })

    manifest = {
        "dataset": "SUN RGB-D V1 (synthetic fixture)",
        "total_images": len(images),
        "valid_images": len(images),
        "sensor_counts": sensor_counts,
        "images": images,
    }
    manifest_path = root_path / "sunrgbd_manifest.json"
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)
    return str(manifest_path)
