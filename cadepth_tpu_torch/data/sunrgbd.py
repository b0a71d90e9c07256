"""SUN RGB-D sample loader with camera-consistent augmentation.

A copy of ``cadepth_tpu.data.sunrgbd``, which imports no JAX: the port
keeps its own so that it never imports the JAX package. Only the package
name changes.

Host-side port of `src/data/sunrgbd_loader.{h,cpp}` producing NHWC
numpy arrays ready for device transfer. Semantics preserved:

* manifest parse + sensor filter (`sunrgbd_loader.cpp:39-79`)
* dynamic RGB/depth discovery inside image dirs (`:81-103`)
* RGB BGR->RGB, /255 (`:221-233, 512-515`); 16-bit depth PNG / 1000 ->
  meters (`:235-259`); intrinsics from 9-float text (`:261-275`);
  extrinsics dir with 3x3-or-4x4 text + identity fallback (`:277-314`);
  scene.txt (`:316-327`); rays.bin or zeros fallback (`:148-156`)
* resize: bilinear RGB/rays, nearest depth, K rescaled by (sx, sy)
  (`:445-489`)
* train-split-only augmentation: random crop shifts cx/cy (`:389-414`),
  horizontal flip mirrors arrays + negates ray-x + reflects cx
  (`:416-430`), brightness/contrast jitter `x*c + b - 1` (`:432-443`)
* seeded RNG (`:23, 185`)

Behavioral quirk kept for parity (SURVEY §2.3): the manifest is never
filtered by split — `split` only gates augmentation. Pass
`split_filtering=True` to consciously fix this with a deterministic
80/20 hash split.

`compute_rays=True` replaces the rays.bin/zeros path with an exact
on-host ray grid from the *resized* K — the TPU-native default, where
rays are derived rather than stored.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from cadepth_tpu_torch.geometry.io import load_ray_directions

ALL_SENSORS = ("kv1", "kv2", "realsense", "xtion")


@dataclasses.dataclass
class AugmentationConfig:
    """Defaults from `sunrgbd_loader.h:31-46`.

    saturation/hue are accepted-but-unused, matching the reference's
    color jitter which only applies brightness/contrast
    (`sunrgbd_loader.cpp:432-443`).
    """

    enable_random_crop: bool = True
    crop_scale_min: float = 0.7
    crop_scale_max: float = 1.0
    enable_horizontal_flip: bool = True
    horizontal_flip_prob: float = 0.5
    enable_color_jitter: bool = True
    brightness_delta: float = 0.2
    contrast_delta: float = 0.2
    saturation_delta: float = 0.2
    hue_delta: float = 0.1
    random_seed: int = 42


def _split_hash(path: str, train_fraction: float = 0.8) -> str:
    """Deterministic per-image split tag from the stable tail of the path
    (sensor/scene components), independent of where the dataset is mounted."""
    key = "/".join(Path(path).parts[-2:])
    digest = hashlib.sha1(key.encode()).digest()
    return "train" if digest[0] / 255.0 < train_fraction else "test"


class SunRGBDLoader:
    """Index-addressable sample loader over a manifest."""

    def __init__(
        self,
        data_dir: str,
        manifest_path: str,
        split: str = "train",
        target_height: int = 480,
        target_width: int = 640,
        allowed_sensors: Sequence[str] = ALL_SENSORS,
        split_filtering: bool = False,
        compute_rays: bool = False,
        rays_on_device: bool = False,
    ):
        self.data_dir = data_dir
        self.manifest_path = manifest_path
        self.split = split
        self.target_height = target_height
        self.target_width = target_width
        self.allowed_sensors = list(allowed_sensors)
        self.split_filtering = split_filtering
        self.compute_rays = compute_rays
        # The jitted train/eval/predict steps derive rays from K on device
        # (train_state._batch_with_rays) and OVERWRITE any host rays, so
        # when a step consumes the batches the host grid is pure waste —
        # ~3.4 ms/sample at 240x320 plus a third of the H2D bytes.
        # rays_on_device=True skips host rays entirely (batches carry no
        # "rays" key; the step inserts them).
        self.rays_on_device = rays_on_device
        self.augmentation_enabled = False
        self.aug_config = AugmentationConfig()
        self.epoch = 0
        self._rng = np.random.default_rng(42)
        self.sample_paths: List[dict] = []
        self._load_manifest()

    # -- manifest ----------------------------------------------------------

    def _load_manifest(self) -> None:
        with open(self.manifest_path) as f:
            manifest = json.load(f)
        self.sample_paths = []
        for info in manifest.get("images", []):
            if not info.get("valid", False):
                continue
            sensor = info["sensor_type"]
            if sensor not in self.allowed_sensors:
                continue
            path = info["path"]
            if self.split_filtering:
                tag = info.get("split") or _split_hash(path)
                if tag != self.split:
                    continue
            image_dir = Path(path)
            if not (image_dir / "intrinsics.txt").exists():
                continue
            self.sample_paths.append({
                "image_dir": image_dir,
                "sensor_type": sensor,
            })

    def __len__(self) -> int:
        return len(self.sample_paths)

    def enable_augmentation(self, config: Optional[AugmentationConfig] = None) -> None:
        self.augmentation_enabled = True
        if config is not None:
            self.aug_config = config
        self._rng = np.random.default_rng(self.aug_config.random_seed)

    def disable_augmentation(self) -> None:
        self.augmentation_enabled = False

    def set_epoch(self, epoch: int) -> None:
        """Mix the epoch into per-sample augmentation RNG keys so each epoch
        re-draws crop/flip/jitter (the reference's shared sequential mt19937
        advances across epochs, `sunrgbd_loader.cpp:23,185`; a pure
        (seed, index) key would freeze each sample's augmentation forever)."""
        self.epoch = int(epoch)

    def set_target_dimensions(self, height: int, width: int) -> None:
        self.target_height = height
        self.target_width = width

    def filter_by_sensor_type(self, sensor_types: Sequence[str]) -> None:
        self.allowed_sensors = list(sensor_types)
        self._load_manifest()

    def get_statistics(self) -> str:
        return (
            "SUN RGB-D Loader Statistics:\n"
            f"  Split: {self.split}\n"
            f"  Total samples: {len(self)}\n"
            f"  Target dimensions: {self.target_height}x{self.target_width}\n"
            f"  Augmentation: {'enabled' if self.augmentation_enabled else 'disabled'}\n"
            f"  Allowed sensors: {' '.join(self.allowed_sensors)}\n"
        )

    # -- per-file loading --------------------------------------------------

    @staticmethod
    def _find_rgb(image_dir: Path) -> Optional[Path]:
        d = image_dir / "image"
        if not d.is_dir():
            return None
        for entry in sorted(d.iterdir()):
            if entry.suffix.lower() in (".jpg", ".jpeg", ".png"):
                return entry
        return None

    @staticmethod
    def _find_depth(image_dir: Path) -> Optional[Path]:
        d = image_dir / "depth"
        if not d.is_dir():
            return None
        for entry in sorted(d.iterdir()):
            if entry.suffix.lower() == ".png":
                return entry
        return None

    @staticmethod
    def _load_rgb(path: Path) -> np.ndarray:
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"Cannot load RGB image: {path}")
        return (cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0)

    @staticmethod
    def _load_depth(path: Path) -> np.ndarray:
        import cv2

        depth = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if depth is None:
            raise IOError(f"Cannot load depth map: {path}")
        if depth.dtype == np.uint16:
            depth = depth.astype(np.float32) / 1000.0  # mm -> m
        else:
            depth = depth.astype(np.float32)
        return depth[..., None]  # (H, W, 1)

    @staticmethod
    def _load_intrinsics(path: Path) -> np.ndarray:
        values = np.loadtxt(path, dtype=np.float32).reshape(-1)
        if values.size < 9:
            raise ValueError(f"Intrinsics file {path} has {values.size} values")
        return values[:9].reshape(3, 3)

    @staticmethod
    def _load_extrinsics(ext_dir: Path) -> np.ndarray:
        """3x3 or 4x4 text file anywhere in extrinsics/; identity fallback
        (`sunrgbd_loader.cpp:277-314`)."""
        if not ext_dir.is_dir():
            return np.eye(4, dtype=np.float32)
        for entry in sorted(ext_dir.iterdir()):
            if entry.suffix != ".txt":
                continue
            try:
                values = np.loadtxt(entry, dtype=np.float32).reshape(-1)
            except Exception:
                continue
            if values.size >= 16:
                return values[:16].reshape(4, 4)
            if values.size >= 9:
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = values[:9].reshape(3, 3)
                return pose
        return np.eye(4, dtype=np.float32)

    @staticmethod
    def _compute_rays(intrinsics: np.ndarray, h: int, w: int) -> np.ndarray:
        fx, fy = intrinsics[0, 0], intrinsics[1, 1]
        cx, cy = intrinsics[0, 2], intrinsics[1, 2]
        u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                           np.arange(h, dtype=np.float32))
        rays = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
        return rays / np.linalg.norm(rays, axis=-1, keepdims=True)

    # -- sample pipeline ----------------------------------------------------

    def get_sample(self, index: int) -> Dict[str, object]:
        """Full per-sample pipeline (`sunrgbd_loader.cpp:105-169`)."""
        info = self.sample_paths[index]
        image_dir: Path = info["image_dir"]

        rgb_path = self._find_rgb(image_dir)
        if rgb_path is None:
            raise IOError(f"RGB image not found: {image_dir}")
        depth_path = self._find_depth(image_dir)
        if depth_path is None:
            raise IOError(f"Depth image not found: {image_dir}")

        sample: Dict[str, object] = {
            "rgb": self._load_rgb(rgb_path),
            "depth": self._load_depth(depth_path),
            "intrinsics": self._load_intrinsics(image_dir / "intrinsics.txt"),
            "extrinsics": self._load_extrinsics(image_dir / "extrinsics"),
            "image_path": str(image_dir),
            "sensor_type": info["sensor_type"],
            "scene_type": "",
        }
        scene_path = image_dir / "scene.txt"
        if scene_path.exists():
            sample["scene_type"] = scene_path.read_text().strip()

        h, w = sample["rgb"].shape[:2]
        rays_path = image_dir / "rays.bin"
        if self.compute_rays or self.rays_on_device:
            # Rays are derived from the FINAL (post-resize/augment) K below —
            # exact by construction, unlike resizing/flipping a precomputed
            # grid (the reference's path, kept for rays.bin inputs).
            sample["rays"] = None
        elif rays_path.exists():
            sample["rays"] = load_ray_directions(rays_path).astype(np.float32)
        else:
            sample["rays"] = np.zeros((h, w, 3), np.float32)

        self._resize_sample(sample)
        if self.augmentation_enabled and self.split == "train":
            self._augment_sample(sample, index)
            self._resize_sample(sample)
        if self.compute_rays and not self.rays_on_device:
            sample["rays"] = self._compute_rays(
                sample["intrinsics"], self.target_height, self.target_width)
        return sample

    def get_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Stack samples into a batch dict with k4 (`sunrgbd_loader.cpp:171-180`).

        With ``rays_on_device`` the "rays" key is absent — the jitted
        steps insert the device-derived grid."""
        samples = [self.get_sample(i) for i in indices]
        k = np.stack([s["intrinsics"] for s in samples])
        batch = {
            "rgb": np.stack([s["rgb"] for s in samples]),
            "depth": np.stack([s["depth"] for s in samples]),
            "intrinsics": k,
            "k4": np.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]], -1),
            "extrinsics": np.stack([s["extrinsics"] for s in samples]),
        }
        if samples[0]["rays"] is not None:
            batch["rays"] = np.stack([s["rays"] for s in samples])
        return batch

    # -- resize + augmentation ----------------------------------------------

    def _resize_sample(self, sample: Dict[str, object]) -> None:
        """Bilinear RGB/rays, nearest depth, K rescale (`sunrgbd_loader.cpp:445-489`)."""
        import cv2

        rgb = sample["rgb"]
        h, w = rgb.shape[:2]
        th, tw = self.target_height, self.target_width
        if (h, w) == (th, tw):
            return
        sample["rgb"] = cv2.resize(rgb, (tw, th), interpolation=cv2.INTER_LINEAR)
        depth = cv2.resize(sample["depth"][..., 0], (tw, th),
                           interpolation=cv2.INTER_NEAREST)
        sample["depth"] = depth[..., None]
        if sample["rays"] is not None and sample["rays"].size:
            sample["rays"] = cv2.resize(sample["rays"], (tw, th),
                                        interpolation=cv2.INTER_LINEAR)
        sx, sy = tw / w, th / h
        k = sample["intrinsics"].copy()
        k[0, 0] *= sx
        k[1, 1] *= sy
        k[0, 2] *= sx
        k[1, 2] *= sy
        sample["intrinsics"] = k

    def _augment_sample(self, sample: Dict[str, object], index: int) -> None:
        """Crop/flip/jitter with camera-consistent K updates
        (`sunrgbd_loader.cpp:352-443`).

        The RNG is derived per (seed, epoch, index) instead of the
        reference's shared sequential mt19937 (`sunrgbd_loader.cpp:23,185`)
        so that the threaded pipeline stays deterministic and race-free
        while still re-drawing augmentations every epoch (set_epoch).
        """
        cfg = self.aug_config
        rng = np.random.default_rng([cfg.random_seed, self.epoch, index])

        if cfg.enable_random_crop:
            scale = rng.uniform(cfg.crop_scale_min, cfg.crop_scale_max)
            h, w = sample["rgb"].shape[:2]
            crop_h, crop_w = int(h * scale), int(w * scale)
            crop_x = int(rng.integers(0, max(1, w - crop_w) + 1))
            crop_y = int(rng.integers(0, max(1, h - crop_h) + 1))
            for key in ("rgb", "depth", "rays"):
                if sample[key] is None:
                    continue
                sample[key] = sample[key][crop_y:crop_y + crop_h,
                                          crop_x:crop_x + crop_w]
            k = sample["intrinsics"].copy()
            k[0, 2] -= crop_x
            k[1, 2] -= crop_y
            sample["intrinsics"] = k

        if cfg.enable_horizontal_flip and rng.uniform() < cfg.horizontal_flip_prob:
            for key in ("rgb", "depth", "rays"):
                if sample[key] is None:
                    continue
                sample[key] = np.ascontiguousarray(sample[key][:, ::-1])
            if sample["rays"] is not None:
                sample["rays"][..., 0] *= -1.0
            k = sample["intrinsics"].copy()
            k[0, 2] = sample["rgb"].shape[1] - k[0, 2] - 1
            sample["intrinsics"] = k

        if cfg.enable_color_jitter:
            brightness = rng.uniform(1.0 - cfg.brightness_delta,
                                     1.0 + cfg.brightness_delta)
            contrast = rng.uniform(1.0 - cfg.contrast_delta,
                                   1.0 + cfg.contrast_delta)
            sample["rgb"] = np.clip(
                sample["rgb"] * contrast + brightness - 1.0, 0.0, 1.0)
