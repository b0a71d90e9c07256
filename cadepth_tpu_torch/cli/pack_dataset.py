"""Pack a SUN RGB-D tree into a decode-once memory-mapped cache (the twin
of ``cli/pack_dataset.py``):

    python -m cadepth_tpu_torch.cli.pack_dataset --data-dir data/sunrgbd \
        --manifest data/manifest/sunrgbd_manifest.json \
        --out data/packed_240x320 --height 240 --width 320

Every valid manifest image is decoded, resized and its K rescaled once
into flat ``.npy`` arrays by ``data/packed.py: pack_dataset``; training
reads them through ``PackedSunRGBDLoader`` (``data.packed_dir``) or holds
them on the card (``data.device_resident``).
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Pack dataset into npy memmaps")
    p.add_argument("--data-dir", required=True, help="SUN RGB-D root")
    p.add_argument("--manifest", required=True, help="sunrgbd_manifest.json")
    p.add_argument("--out", required=True, help="Output pack directory")
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float16"),
                   help="Array dtype (float16 halves disk, ~1e-3 rel error)")
    p.add_argument("--sensors", default="kv1,kv2,realsense,xtion",
                   help="Comma-separated sensor filter")
    p.add_argument("--threads", type=int, default=8)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from cadepth_tpu_torch.data.packed import pack_dataset

    t0 = time.perf_counter()
    meta = pack_dataset(
        args.data_dir, args.manifest, args.out,
        target_height=args.height, target_width=args.width,
        dtype=args.dtype,
        allowed_sensors=[s.strip() for s in args.sensors.split(",") if s],
        num_threads=args.threads)
    elapsed = time.perf_counter() - t0
    n = meta["num_samples"]
    per_sample = (args.height * args.width * 4
                  * (4 if args.dtype == "float32" else 2))
    print(f"Packed {n} samples at {args.height}x{args.width} ({args.dtype}) "
          f"into {args.out} in {elapsed:.1f}s "
          f"(~{n * per_sample / 2**30:.2f} GiB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
