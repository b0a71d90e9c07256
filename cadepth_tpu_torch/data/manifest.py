"""SUN RGB-D dataset validation + manifest generation.

A copy of ``cadepth_tpu.data.manifest``, which imports no JAX: the port
keeps its own so that it never imports the JAX package. Only the package
name changes.

Python port of the standalone validator binary
(`scripts/validate_sunrgbd.cpp`): walks
`<data_dir>/{kv1,kv2,realsense,xtion}` (or `<data_dir>/SUNRGBD/<sensor>`)
recursively, validates every image directory, prints a per-sensor
summary, and writes `sunrgbd_manifest.json` with the same JSON schema
(`validate_sunrgbd.cpp:273-313`).

An image directory is valid when it contains (`validate_sunrgbd.cpp:96-230`):
  * `intrinsics.txt` — 9 floats, fx/fy > 0, K[2,2] == 1
  * `image/*.jpg|png` — decodable RGB
  * `depth/*.png` — 16- or 32-bit depth
Optional: `extrinsics/` dir, `scene.txt`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

SENSOR_TYPES = ("kv1", "kv2", "realsense", "xtion")


@dataclasses.dataclass
class ValidationResult:
    """Per-image-directory validation record (`validate_sunrgbd.cpp:13-29`)."""

    image_path: str = ""
    sensor_type: str = ""
    is_valid: bool = False
    has_intrinsics: bool = False
    has_rgb: bool = False
    has_depth: bool = False
    has_extrinsics: bool = False
    has_scene_info: bool = False
    rgb_width: int = 0
    rgb_height: int = 0
    depth_width: int = 0
    depth_height: int = 0
    errors: List[str] = dataclasses.field(default_factory=list)


def _find_first(directory: Path, extensions: tuple) -> Optional[Path]:
    if not directory.is_dir():
        return None
    for entry in sorted(directory.iterdir()):
        if entry.suffix.lower() in extensions:
            return entry
    return None


class SunRGBDValidator:
    """Walks a SUN RGB-D tree and validates every image directory."""

    def __init__(self, data_dir: str):
        self.data_dir = Path(data_dir)

    def validate_all_images(self) -> List[ValidationResult]:
        """Per-sensor recursive walk (`validate_sunrgbd.cpp:35-94`)."""
        results: List[ValidationResult] = []
        for sensor in SENSOR_TYPES:
            for root in (self.data_dir / sensor, self.data_dir / "SUNRGBD" / sensor):
                if root.is_dir():
                    results.extend(self._validate_sensor_dir(root, sensor))
                    break
        return results

    def _validate_sensor_dir(self, root: Path, sensor: str) -> List[ValidationResult]:
        results = []
        for dirpath, dirnames, filenames in os.walk(root):
            if "intrinsics.txt" in filenames:
                results.append(self.validate_image_directory(Path(dirpath), sensor))
                dirnames.clear()  # image dirs don't nest
        return results

    def validate_image_directory(self, image_dir: Path, sensor: str) -> ValidationResult:
        result = ValidationResult(image_path=str(image_dir), sensor_type=sensor)

        intrinsics_path = image_dir / "intrinsics.txt"
        if intrinsics_path.exists():
            err = self._validate_intrinsics(intrinsics_path)
            if err is None:
                result.has_intrinsics = True
            else:
                result.errors.append(err)
        else:
            result.errors.append("Missing intrinsics.txt")

        rgb_path = _find_first(image_dir / "image", (".jpg", ".jpeg", ".png"))
        if rgb_path is not None:
            dims = self._probe_image(rgb_path)
            if dims is not None:
                result.has_rgb = True
                result.rgb_width, result.rgb_height = dims
            else:
                result.errors.append(f"Cannot load RGB image: {rgb_path}")
        else:
            result.errors.append("Missing RGB image in image/")

        depth_path = _find_first(image_dir / "depth", (".png",))
        if depth_path is not None:
            dims = self._probe_depth(depth_path)
            if dims is not None:
                result.has_depth = True
                result.depth_width, result.depth_height = dims
            else:
                result.errors.append(f"Invalid depth image (need 16/32-bit PNG): {depth_path}")
        else:
            result.errors.append("Missing depth image in depth/")

        result.has_extrinsics = (image_dir / "extrinsics").is_dir()
        result.has_scene_info = (image_dir / "scene.txt").exists()
        result.is_valid = result.has_intrinsics and result.has_rgb and result.has_depth
        return result

    @staticmethod
    def _validate_intrinsics(path: Path) -> Optional[str]:
        """fx, fy > 0 and K[2,2] == 1 (`validate_sunrgbd.cpp:154-183`)."""
        try:
            values = np.loadtxt(path, dtype=np.float64).reshape(-1)
        except Exception as exc:  # malformed text
            return f"Cannot parse intrinsics: {exc}"
        if values.size < 9:
            return f"Intrinsics has {values.size} values, need 9"
        k = values[:9].reshape(3, 3)
        if k[0, 0] <= 0 or k[1, 1] <= 0:
            return f"Invalid focal lengths fx={k[0, 0]}, fy={k[1, 1]}"
        if abs(k[2, 2] - 1.0) > 1e-5:
            return f"K[2,2] = {k[2, 2]} != 1"
        return None

    @staticmethod
    def _probe_image(path: Path) -> Optional[tuple]:
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is None:
            return None
        return img.shape[1], img.shape[0]

    @staticmethod
    def _probe_depth(path: Path) -> Optional[tuple]:
        import cv2

        depth = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if depth is None:
            return None
        if depth.dtype not in (np.uint16, np.int32, np.float32):
            return None
        return depth.shape[1], depth.shape[0]


def print_summary(results: List[ValidationResult]) -> str:
    """Per-sensor valid counts + first-10 errors (`validate_sunrgbd.cpp:233-271`)."""
    lines = ["", "=== VALIDATION SUMMARY ===",
             f"Total images validated: {len(results)}"]
    valid = [r for r in results if r.is_valid]
    lines.append(f"Valid images: {len(valid)}/{len(results)}")
    lines.append("")
    lines.append("Breakdown by sensor:")
    sensor_counts: Dict[str, int] = {}
    sensor_valid: Dict[str, int] = {}
    for r in results:
        sensor_counts[r.sensor_type] = sensor_counts.get(r.sensor_type, 0) + 1
        if r.is_valid:
            sensor_valid[r.sensor_type] = sensor_valid.get(r.sensor_type, 0) + 1
    for sensor in sorted(sensor_counts):
        lines.append(f"  {sensor}: {sensor_valid.get(sensor, 0)}/{sensor_counts[sensor]} valid")
    errors_shown = 0
    for r in results:
        if not r.is_valid and errors_shown < 10:
            if errors_shown == 0:
                lines.append("")
                lines.append("=== SAMPLE ERRORS (first 10) ===")
            lines.append(f"Image: {r.image_path} ({r.sensor_type})")
            for e in r.errors:
                lines.append(f"  - {e}")
            errors_shown += 1
    text = "\n".join(lines)
    print(text)
    return text


def save_manifest(results: List[ValidationResult], output_path: str) -> dict:
    """Write the manifest JSON (schema of `validate_sunrgbd.cpp:273-313`)."""
    sensor_counts: Dict[str, int] = {}
    images = []
    valid_count = 0
    for r in results:
        sensor_counts[r.sensor_type] = sensor_counts.get(r.sensor_type, 0) + 1
        if r.is_valid:
            valid_count += 1
            images.append({
                "path": r.image_path,
                "sensor_type": r.sensor_type,
                "has_intrinsics": r.has_intrinsics,
                "has_rgb": r.has_rgb,
                "has_depth": r.has_depth,
                "has_extrinsics": r.has_extrinsics,
                "has_scene_info": r.has_scene_info,
                "rgb_resolution": [r.rgb_width, r.rgb_height],
                "depth_resolution": [r.depth_width, r.depth_height],
                "valid": True,
            })
    manifest = {
        "dataset": "SUN RGB-D V1",
        "total_images": len(results),
        "valid_images": valid_count,
        "sensor_counts": sensor_counts,
        "images": images,
    }
    with open(output_path, "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"\nManifest saved to: {output_path}")
    return manifest


def load_manifest(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
