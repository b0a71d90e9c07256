"""Packed (decode-once) dataset cache: memory-mapped device-ready samples.

A copy of ``cadepth_tpu.data.packed``, which imports no JAX: the port
keeps its own so that it never imports the JAX package. Only the package
name changes.

The reference decodes PNG/JPEG from disk on every epoch inside the train
loop (`sunrgbd_loader.cpp:105-169`) — its only offline precompute stage
is the per-scene ray grids (`preprocess_rays_main.cpp:20-130`). On a TPU
VM the chip sustains hundreds of images/sec, so repeated image decode is
the dominant host cost. This module extends the precompute idea to the
whole sample: decode + resize + K-rescale ONCE into flat ``.npy`` arrays
(`pack_dataset`), then train epochs read them back via ``numpy`` memory
maps (`PackedSunRGBDLoader`) at memcpy speed.

Parity: the live loader's pipeline is decode -> resize-to-target ->
augment -> resize-to-target (`sunrgbd.py:get_sample`); augmentation acts
on the *already resized* sample, so packing the post-first-resize arrays
and running the identical augment/resize tail at read time reproduces
the live path bit-for-bit (float32 packs; float16 halves disk at ~1e-3
relative error, for quick experiments).

Rays are derived from the final (post-augment) K at read time — the
TPU-native default (`compute_rays=True`); packed files never store ray
grids, unlike the reference's per-frame ``rays.bin`` duplication.

Layout of a pack directory::

    packed_meta.json   pack options, per-sample path/sensor/scene records
    rgb.npy            (N, H, W, 3) float32|float16 in [0, 1]
    depth.npy          (N, H, W, 1) float32|float16 meters
    intrinsics.npy     (N, 3, 3) float32 (rescaled to pack dims)
    extrinsics.npy     (N, 4, 4) float32
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from cadepth_tpu_torch.data.sunrgbd import ALL_SENSORS, SunRGBDLoader, _split_hash

_META_NAME = "packed_meta.json"


def pack_dataset(
    data_dir: str,
    manifest_path: str,
    out_dir: str,
    target_height: int,
    target_width: int,
    dtype: str = "float32",
    allowed_sensors: Sequence[str] = ALL_SENSORS,
    num_threads: int = 8,
) -> Dict[str, object]:
    """Decode every valid manifest sample once into a pack directory.

    Samples are stored post-resize (bilinear RGB / nearest depth, K
    rescaled — `sunrgbd_loader.cpp:445-489` semantics via the live
    loader), pre-augmentation, so every split/augmentation decision
    stays a read-time choice.

    Returns the metadata dict (also written to ``packed_meta.json``).
    """
    if dtype not in ("float32", "float16"):
        raise ValueError(f"dtype must be float32|float16, got {dtype}")
    loader = SunRGBDLoader(
        data_dir, manifest_path, split="pack",  # never augments
        target_height=target_height, target_width=target_width,
        allowed_sensors=allowed_sensors, compute_rays=False)
    n = len(loader)
    if n == 0:
        raise ValueError(f"No valid samples in {manifest_path}")
    # Preserve any explicit per-image split tags (the live loader honors
    # them before falling back to the hash split, `sunrgbd.py:117`).
    with open(manifest_path) as f:
        split_tags = {img["path"]: img["split"]
                      for img in json.load(f).get("images", [])
                      if img.get("split")}

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np_dtype = np.dtype(dtype)
    rgb = np.lib.format.open_memmap(
        out / "rgb.npy", mode="w+", dtype=np_dtype,
        shape=(n, target_height, target_width, 3))
    depth = np.lib.format.open_memmap(
        out / "depth.npy", mode="w+", dtype=np_dtype,
        shape=(n, target_height, target_width, 1))
    intrinsics = np.lib.format.open_memmap(
        out / "intrinsics.npy", mode="w+", dtype=np.float32, shape=(n, 3, 3))
    extrinsics = np.lib.format.open_memmap(
        out / "extrinsics.npy", mode="w+", dtype=np.float32, shape=(n, 4, 4))

    records = [None] * n

    def pack_one(i: int) -> None:
        s = loader.get_sample(i)
        rgb[i] = s["rgb"]
        depth[i] = s["depth"]
        intrinsics[i] = s["intrinsics"]
        extrinsics[i] = s["extrinsics"]
        records[i] = {
            "path": s["image_path"],
            "sensor_type": s["sensor_type"],
            "scene_type": s["scene_type"],
            "split": split_tags.get(s["image_path"], ""),
        }

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        list(pool.map(pack_one, range(n)))
    rgb.flush()
    depth.flush()
    intrinsics.flush()
    extrinsics.flush()

    meta = {
        "format_version": 1,
        "num_samples": n,
        "height": target_height,
        "width": target_width,
        "dtype": dtype,
        "source_manifest": str(manifest_path),
        "source_data_dir": str(data_dir),
        "samples": records,
    }
    with open(out / _META_NAME, "w") as f:
        json.dump(meta, f)
    return meta


class PackedSunRGBDLoader(SunRGBDLoader):
    """Drop-in ``SunRGBDLoader`` over a pack directory (no image decode).

    Supports the same read-time behavior as the live loader — sensor
    filtering, the split-gated augmentation quirk, opt-in
    ``split_filtering``, epoch-keyed augmentation, target-dim override
    (packs store one resolution; a different requested resolution is a
    cheap array resize) — but ``get_sample`` is a memmap copy instead of
    two image decodes.
    """

    #: InputPipeline gate: the native C++ decode path re-reads image
    #: files from disk, which is exactly what a packed loader avoids.
    supports_native = False

    def __init__(
        self,
        pack_dir: str,
        split: str = "train",
        target_height: Optional[int] = None,
        target_width: Optional[int] = None,
        allowed_sensors: Sequence[str] = ALL_SENSORS,
        split_filtering: bool = False,
        compute_rays: bool = True,
        rays_on_device: bool = False,
        preload: bool = False,
    ):
        pack = Path(pack_dir)
        with open(pack / _META_NAME) as f:
            self.meta = json.load(f)
        self.pack_dir = pack
        self.split = split
        self.target_height = int(target_height or self.meta["height"])
        self.target_width = int(target_width or self.meta["width"])
        self.allowed_sensors = list(allowed_sensors)
        self.split_filtering = split_filtering
        self.compute_rays = compute_rays
        self.rays_on_device = rays_on_device  # see SunRGBDLoader
        self.augmentation_enabled = False
        from cadepth_tpu_torch.data.sunrgbd import AugmentationConfig

        self.aug_config = AugmentationConfig()
        self.epoch = 0
        self._rng = np.random.default_rng(42)
        # preload=True copies the pack into anonymous RAM instead of
        # memory-mapping it: file-backed pages are reclaimable (and some
        # hosts run proactive reclaim — e.g. DAMON pageout — that evicts
        # once-per-epoch access patterns back to disk), while anonymous
        # pages are pinned wherever swap is disabled. Costs the pack's
        # full size in RAM; TPU-VM hosts have hundreds of GB.
        mmap_mode = None if preload else "r"
        self.preload = preload
        self._rgb = np.load(pack / "rgb.npy", mmap_mode=mmap_mode)
        self._depth = np.load(pack / "depth.npy", mmap_mode=mmap_mode)
        self._intrinsics = np.load(pack / "intrinsics.npy",
                                   mmap_mode=mmap_mode)
        self._extrinsics = np.load(pack / "extrinsics.npy",
                                   mmap_mode=mmap_mode)
        self._load_manifest()

    def warm(self) -> None:
        """Prefault the memmaps into the page cache (sequential read).

        A freshly written (or freshly booted) pack reads at disk speed
        on first touch; epochs 2+ run at memcpy speed. Call this once
        before training to pay the fault cost up front, sequentially
        (~5x faster than faulting in shuffle order)."""
        for arr in (self._rgb, self._depth, self._intrinsics,
                    self._extrinsics):
            for i in range(0, arr.shape[0], 64):
                np.sum(arr[i:i + 64], dtype=np.float64)

    def _load_manifest(self) -> None:
        """Build the filtered index over pack records (mirrors the live
        loader's manifest pass, including split_filtering semantics)."""
        self.sample_paths = []
        for row, rec in enumerate(self.meta["samples"]):
            if rec["sensor_type"] not in self.allowed_sensors:
                continue
            if self.split_filtering:
                tag = rec.get("split") or _split_hash(rec["path"])
                if tag != self.split:
                    continue
            self.sample_paths.append({
                "image_dir": Path(rec["path"]),
                "sensor_type": rec["sensor_type"],
                "scene_type": rec.get("scene_type", ""),
                "row": row,
            })

    def filter_by_sensor_type(self, sensor_types: Sequence[str]) -> None:
        self.allowed_sensors = list(sensor_types)
        self._load_manifest()

    def fast_batch_applicable(self) -> bool:
        """True when batches need no per-sample Python work (see
        :meth:`fast_batch`)."""
        augmenting = self.augmentation_enabled and self.split == "train"
        resizing = (self.target_height, self.target_width) != \
            tuple(self._rgb.shape[1:3])
        return not augmenting and not resizing and (self.compute_rays
                                                    or self.rays_on_device)

    def fast_batch(self, indices: Sequence[int]) -> Optional[Dict[str, np.ndarray]]:
        """Vectorized pipeline-batch assembly, or None if inapplicable.

        When no per-sample Python work is needed (augmentation off or
        non-train split, no target-dim override, device-derived rays),
        a batch is a single fancy-index per array — one C-level copy
        instead of B ``get_sample`` calls + ``np.stack``. ~10x cheaper
        host-side than the threaded per-sample path, which matters when
        the host is core-starved. Returns the InputPipeline batch
        schema (no "extrinsics" key, no "rays" key)."""
        if not self.fast_batch_applicable():
            return None
        rows = [self.sample_paths[int(i)]["row"] for i in indices]
        k = np.asarray(self._intrinsics[rows], dtype=np.float32)
        batch = {
            "rgb": np.asarray(self._rgb[rows], dtype=np.float32),
            "depth": np.asarray(self._depth[rows], dtype=np.float32),
            "intrinsics": k,
            "k4": np.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]],
                           -1).astype(np.float32),
        }
        if not self.rays_on_device:
            batch["rays"] = np.stack([
                self._compute_rays(k[i], self.target_height,
                                   self.target_width)
                for i in range(len(rows))])
        return batch

    def get_sample(self, index: int) -> Dict[str, object]:
        """Memmap copy + the live loader's augment/resize/rays tail."""
        info = self.sample_paths[index]
        row = info["row"]
        sample: Dict[str, object] = {
            "rgb": np.asarray(self._rgb[row], dtype=np.float32),
            "depth": np.asarray(self._depth[row], dtype=np.float32),
            "intrinsics": np.array(self._intrinsics[row]),
            "extrinsics": np.array(self._extrinsics[row]),
            "image_path": str(info["image_dir"]),
            "sensor_type": info["sensor_type"],
            "scene_type": info["scene_type"],
            "rays": None if (self.compute_rays or self.rays_on_device)
            else np.zeros(self._rgb.shape[1:3] + (3,), np.float32),
        }
        # Identical tail to SunRGBDLoader.get_sample: the pack stores the
        # post-first-resize state, so resize here is a no-op unless the
        # caller asked for different target dims than the pack's.
        self._resize_sample(sample)
        if self.augmentation_enabled and self.split == "train":
            self._augment_sample(sample, index)
            self._resize_sample(sample)
        if self.compute_rays and not self.rays_on_device:
            sample["rays"] = self._compute_rays(
                sample["intrinsics"], self.target_height, self.target_width)
        return sample
