"""Asynchronous host input pipeline with device prefetch (port of
``cadepth_tpu.data.pipeline``).

The epoch order, the producer threads, the bounded prefetch queue, the
``stop`` event and the three producers (the native C++ batch loader, a
packed loader's whole-batch ``fast_batch``, and per-sample decode on a
thread pool) are the JAX pipeline's, so both yield the same batches in
the same order. What differs is the copy to the device, which JAX does
with ``jax.device_put`` in the producer thread:

* on a card, each host batch is written into pinned host buffers (a ring
  of ``prefetch_depth + 2`` per key, reused: pinning per batch would be
  a ``cudaHostAlloc`` each time) and copied with ``non_blocking=True`` on
  a CUDA stream of the pipeline's own, so the copy overlaps the step
  running on the consumer's stream. An event recorded after the copy is
  queued with the batch; the consumer's stream waits on it, and every
  yielded tensor is marked with ``record_stream`` on the consumer's
  stream, so the caching allocator does not hand its memory to a later
  copy while the step still reads it. A ring slot is written again only
  after the host has seen its last copy's event;
* on the CPU, batches are the numpy arrays as tensors (no pinning, no
  stream).

``process_index`` / ``process_count`` slice each global batch as the JAX
pipeline does; each process then yields its local slice (the Trainer
passes its rank and the group's size under data parallelism).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from cadepth_tpu_torch.data.sunrgbd import SunRGBDLoader
from cadepth_tpu_torch.models.factory import resolve_device

_STOP = object()


class _PinnedRing:
    """``slots`` pinned host buffers per key, handed out in turn; a slot is
    written only after the copy that last read it has finished."""

    def __init__(self, slots: int):
        self.slots = slots
        self._buffers: Dict[str, List[torch.Tensor]] = {}
        self._events: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0

    def take(self, batch: Dict[str, np.ndarray]):
        """(slot index, {key: pinned tensor holding the array})."""
        slot = self._next
        self._next = (slot + 1) % self.slots
        event = self._events[slot]
        if event is not None:
            event.synchronize()
        out = {}
        for key, value in batch.items():
            dtype = torch.from_numpy(np.empty(0, value.dtype)).dtype
            bufs = self._buffers.get(key)
            if bufs is None or bufs[0].dtype != dtype or \
                    bufs[0].shape[1:] != value.shape[1:] or \
                    bufs[0].shape[0] < value.shape[0]:
                # the first batch (a full one) sets the size; a shorter
                # last batch takes the front of a slot
                bufs = self._buffers[key] = [
                    torch.empty(value.shape, dtype=dtype, pin_memory=True)
                    for _ in range(self.slots)]
            buf = bufs[slot][:value.shape[0]]
            np.copyto(buf.numpy(), value, casting="no")
            out[key] = buf
        return slot, out

    def release_after(self, slot: int, event: torch.cuda.Event) -> None:
        self._events[slot] = event


class InputPipeline:
    """Iterable over prefetched device batches (dicts of tensors)."""

    def __init__(
        self,
        loader: SunRGBDLoader,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 42,
        num_threads: int = 8,
        prefetch_depth: int = 2,
        drop_remainder: bool = True,
        max_samples: Optional[int] = None,
        use_native: str = "auto",
        process_index: int = 0,
        process_count: int = 1,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.loader = loader
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch_depth = prefetch_depth
        self.drop_remainder = drop_remainder
        self.max_samples = max_samples
        self._epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        if batch_size % self.process_count != 0:
            raise ValueError(
                f"batch_size {batch_size} not divisible by process_count "
                f"{self.process_count}")
        self._local_bs = batch_size // self.process_count
        if self.process_count > 1 and not drop_remainder:
            raise ValueError(
                "multi-process loading requires drop_remainder=True")
        # Native C++ batch loader (GIL-free decode). "auto" uses it when the
        # shared library builds/loads AND the loader derives rays from K
        # (the native path doesn't read rays.bin side files).
        self._native = False
        if use_native in ("auto", "always"):
            from cadepth_tpu_torch.data import native as _native_mod

            ok = (_native_mod.available()
                  and (loader.compute_rays
                       or getattr(loader, "rays_on_device", False))
                  and getattr(loader, "supports_native", True))
            if use_native == "always" and not ok:
                raise RuntimeError(
                    "use_native='always' but the native loader is unavailable "
                    "(build native/build.sh and use compute_rays=True)")
            self._native = ok
            self._native_mod = _native_mod if ok else None
        # the copy to a card: its own stream and the pinned ring, made at
        # the first copy
        self._stream: Optional[torch.cuda.Stream] = None
        self._ring: Optional[_PinnedRing] = None
        # which producer fed the last epoch: "native", "fast" or
        # "per-sample"
        self.producer = ""
        # seconds the consumer waited on the queue in the last epoch
        self.wait_seconds = 0.0

    def __len__(self) -> int:
        n = len(self.loader)
        if self.max_samples is not None:
            n = min(n, self.max_samples)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.loader)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        if self.max_samples is not None:
            idx = idx[: self.max_samples]
        return idx

    def _assemble(self, samples) -> Dict[str, np.ndarray]:
        k = np.stack([s["intrinsics"] for s in samples])
        batch = {
            "rgb": np.stack([s["rgb"] for s in samples]),
            "depth": np.stack([s["depth"] for s in samples]),
            "intrinsics": k.astype(np.float32),
            "k4": np.stack(
                [k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]], -1
            ).astype(np.float32),
        }
        if samples[0]["rays"] is not None:  # rays_on_device omits the key
            batch["rays"] = np.stack([s["rays"] for s in samples])
        return batch

    def _to_device(self, batch: Dict[str, np.ndarray]):
        """(tensors, the copy's event or None) of a host batch."""
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in batch.items()}, None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._ring = _PinnedRing(self.prefetch_depth + 2)
        slot, pinned = self._ring.take(batch)
        with torch.cuda.stream(self._stream):
            out = {k: v.to(self.device, non_blocking=True)
                   for k, v in pinned.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        self._ring.release_after(slot, event)
        return out, event

    def _native_batch(self, batch_indices) -> Dict[str, np.ndarray]:
        loader = self.loader
        dirs = [str(loader.sample_paths[int(i)]["image_dir"])
                for i in batch_indices]
        augment = None
        seeds = None
        if loader.augmentation_enabled and loader.split == "train":
            cfg = loader.aug_config
            augment = {
                "enable_crop": cfg.enable_random_crop,
                "crop_scale_min": cfg.crop_scale_min,
                "crop_scale_max": cfg.crop_scale_max,
                "enable_flip": cfg.enable_horizontal_flip,
                "flip_prob": cfg.horizontal_flip_prob,
                "enable_jitter": cfg.enable_color_jitter,
                "brightness_delta": cfg.brightness_delta,
                "contrast_delta": cfg.contrast_delta,
            }
            # per-(seed, epoch, index) streams like the Python loader
            seeds = [(cfg.random_seed << 20) ^ (loader.epoch << 40) ^ int(i)
                     for i in batch_indices]
        return self._native_mod.load_batch(
            dirs, loader.target_height, loader.target_width,
            augment=augment, aug_seeds=seeds,
            compute_rays=not getattr(loader, "rays_on_device", False),
            num_threads=self.num_threads)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        indices = self._epoch_indices()
        # Re-key augmentation per epoch (see SunRGBDLoader.set_epoch); the
        # producer thread reads loader.epoch, set once before it starts.
        self.loader.set_epoch(self._epoch)
        self._epoch += 1
        num_batches = len(indices) // self.batch_size
        remainder = len(indices) % self.batch_size
        if not self.drop_remainder and remainder:
            num_batches += 1

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()
        error: list = []

        def emit(batch) -> bool:
            """Copy to the device + enqueue; returns False if the consumer
            is gone."""
            item = self._to_device(batch)
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def local_slice(chunk):
            if self.process_count == 1:
                return chunk
            lo = self.process_index * self._local_bs
            return chunk[lo:lo + self._local_bs]

        def batch_indices(b):
            return local_slice(
                indices[b * self.batch_size:(b + 1) * self.batch_size])

        def producer_native():
            try:
                for b in range(num_batches):
                    if stop.is_set():
                        return
                    if not emit(self._native_batch(batch_indices(b))):
                        return
            except Exception as exc:
                error.append(exc)
            finally:
                out_q.put(_STOP)

        def producer_fast():
            """Whole-batch vectorized assembly (packed loaders, no
            augmentation): one fancy-index per array, no thread pool."""
            try:
                for b in range(num_batches):
                    if stop.is_set():
                        return
                    batch = self.loader.fast_batch(batch_indices(b))
                    if batch is None:  # applicability flipped mid-epoch
                        batch = self._assemble(
                            [self.loader.get_sample(int(i))
                             for i in batch_indices(b)])
                    if not emit(batch):
                        return
            except Exception as exc:
                error.append(exc)
            finally:
                out_q.put(_STOP)

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                    # Windowed submission: only `lookahead` batches of decode
                    # futures are in flight, bounding host memory.
                    lookahead = self.prefetch_depth + 2
                    pending = {
                        b: [pool.submit(self.loader.get_sample, int(i))
                            for i in batch_indices(b)]
                        for b in range(min(lookahead, num_batches))
                    }
                    for b in range(num_batches):
                        if stop.is_set():
                            return
                        samples = [f.result() for f in pending.pop(b)]
                        nxt = b + lookahead
                        if nxt < num_batches and not stop.is_set():
                            pending[nxt] = [
                                pool.submit(self.loader.get_sample, int(i))
                                for i in batch_indices(nxt)]
                        if not emit(self._assemble(samples)):
                            return
            except Exception as exc:  # surface in consumer
                error.append(exc)
            finally:
                out_q.put(_STOP)

        self.producer = "per-sample"
        if self._native:
            producer, self.producer = producer_native, "native"
        elif getattr(self.loader, "fast_batch_applicable",
                     lambda: False)():
            producer, self.producer = producer_fast, "fast"

        self.wait_seconds = 0.0
        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = out_q.get()
                self.wait_seconds += time.perf_counter() - t0
                if item is _STOP:
                    break
                batch, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for t in batch.values():
                        t.record_stream(stream)
                yield batch
        finally:
            # consumer done or abandoned the iterator: release the producer
            stop.set()
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=30)
        if error:
            raise error[0]
