"""ctypes bindings for the native C++ data pipeline (native/dataloader.cpp).

A copy of ``cadepth_tpu.data.native``, which imports no JAX: the port
keeps its own so that it never imports the JAX package. Only the package
name changes.

The native loader is the production host path: GIL-free multithreaded
decode+resize+augment into packed NHWC float32 batch buffers. Semantics
match :class:`cadepth_tpu_torch.data.sunrgbd.SunRGBDLoader` exactly on the
non-augmented path (both are OpenCV underneath); augmentation matches in
distribution (different RNG streams) with identical camera-consistency
rules.

Builds on demand via `native/build.sh` (g++ + OpenCV); callers should
fall back to the Python loader when :func:`available` is False.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libcadepth_native.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> bool:
    script = _NATIVE_DIR / "build.sh"
    if not script.exists():
        return False
    try:
        subprocess.run(["bash", str(script)], check=True,
                       capture_output=True, timeout=300)
        return _LIB_PATH.exists()
    except (subprocess.SubprocessError, OSError):
        return False


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not _LIB_PATH.exists() and not _build():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            _load_failed = True
            return None
        lib.cadepth_load_batch.restype = ctypes.c_int
        lib.cadepth_ray_grid.restype = None
        lib.cadepth_version.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def available() -> bool:
    return _get_lib() is not None


def version() -> str:
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib.cadepth_version().decode()


def ray_grid(intrinsics: np.ndarray, height: int, width: int) -> np.ndarray:
    """Native closed-form ray grid (same formula as geometry.rays.ray_grid)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    k = np.ascontiguousarray(intrinsics, np.float32).reshape(9)
    out = np.empty((height, width, 3), np.float32)
    lib.cadepth_ray_grid(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(height), ctypes.c_int(width),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def load_batch(
    image_dirs: Sequence[str],
    target_height: int,
    target_width: int,
    augment: Optional[dict] = None,
    aug_seeds: Optional[Sequence[int]] = None,
    compute_rays: bool = True,
    num_threads: int = 0,
) -> Dict[str, np.ndarray]:
    """Decode a batch of image dirs into packed NHWC arrays.

    `augment` keys (all optional): enable_crop, crop_scale_min,
    crop_scale_max, enable_flip, flip_prob, enable_jitter,
    brightness_delta, contrast_delta. Augmentation runs only when
    `aug_seeds` is given (one uint64 per sample).
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable; run native/build.sh")
    b = len(image_dirs)
    h, w = target_height, target_width
    rgb = np.empty((b, h, w, 3), np.float32)
    depth = np.empty((b, h, w, 1), np.float32)
    rays = np.empty((b, h, w, 3), np.float32) if compute_rays else None
    k = np.empty((b, 3, 3), np.float32)
    err = ctypes.create_string_buffer(512)

    dirs_arr = (ctypes.c_char_p * b)(
        *[str(d).encode() for d in image_dirs])
    seeds_arr = None
    if aug_seeds is not None:
        seeds_arr = (ctypes.c_uint64 * b)(*[int(s) for s in aug_seeds])
    aug = augment or {}

    def fptr(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    rc = lib.cadepth_load_batch(
        dirs_arr, ctypes.c_int(b), ctypes.c_int(h), ctypes.c_int(w),
        ctypes.c_int(int(aug.get("enable_crop", False))),
        ctypes.c_float(aug.get("crop_scale_min", 0.7)),
        ctypes.c_float(aug.get("crop_scale_max", 1.0)),
        ctypes.c_int(int(aug.get("enable_flip", False))),
        ctypes.c_float(aug.get("flip_prob", 0.5)),
        ctypes.c_int(int(aug.get("enable_jitter", False))),
        ctypes.c_float(aug.get("brightness_delta", 0.2)),
        ctypes.c_float(aug.get("contrast_delta", 0.2)),
        seeds_arr,
        ctypes.c_int(int(compute_rays)),
        ctypes.c_int(num_threads),
        fptr(rgb), fptr(depth),
        fptr(rays) if rays is not None else None,
        fptr(k), err, ctypes.c_int(len(err)))
    if rc != 0:
        raise IOError(f"native load_batch failed: {err.value.decode()}")

    batch = {
        "rgb": rgb,
        "depth": depth,
        "intrinsics": k,
        "k4": np.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]], -1),
    }
    if rays is not None:
        batch["rays"] = rays
    return batch
