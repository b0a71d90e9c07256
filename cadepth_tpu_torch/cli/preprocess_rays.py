"""Ray-direction preprocessing CLI (the twin of ``cli/preprocess_rays.py``):

    python -m cadepth_tpu_torch.cli.preprocess_rays --data_dir data/sunrgbd \
        [--height 480 --width 640 | --native-resolution] [--device cuda|cpu]

Writes a reference-format ``rays.bin`` (``geometry/io.py:
save_ray_directions``) beside every ``intrinsics.txt`` under the tree. The
training and serving paths derive rays from K on the device and never
read these files; they exist for interop with the reference. The grid is
the one the steps use (``geometry/rays.py: ray_grid``), computed on the
card unless ``--device cpu`` (the JAX CLI's ``--platform``) asks for the
CPU. With ``--native-resolution`` each directory takes the size of its
first RGB image, read through cv2.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Precompute rays.bin files")
    p.add_argument("--data_dir", required=True,
                   help="SUN RGB-D root (walks for intrinsics.txt)")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--native-resolution", action="store_true",
                   help="Use each image's native RGB resolution instead of "
                        "--height/--width")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Where to compute the grids (cuda raises without "
                        "a card)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from cadepth_tpu_torch.geometry.io import (load_intrinsics_txt,
                                               save_ray_directions)
    from cadepth_tpu_torch.geometry.rays import ray_grid
    from cadepth_tpu_torch.models.factory import resolve_device

    device = resolve_device(args.device)
    root = Path(args.data_dir)
    image_dirs = sorted({p.parent for p in root.rglob("intrinsics.txt")})
    print(f"Found {len(image_dirs)} image directories under {root}")

    done = 0
    for image_dir in image_dirs:
        try:
            k = load_intrinsics_txt(image_dir / "intrinsics.txt")
        except ValueError as exc:
            print(f"  skip {image_dir}: {exc}", file=sys.stderr)
            continue
        h, w = args.height, args.width
        if args.native_resolution:
            import cv2

            rgb_dir = image_dir / "image"
            candidates = sorted(rgb_dir.glob("*")) if rgb_dir.is_dir() else []
            if candidates:
                img = cv2.imread(str(candidates[0]))
                if img is not None:
                    h, w = img.shape[:2]
        rays = ray_grid(torch.from_numpy(k).to(device), h, w)
        save_ray_directions(image_dir / "rays.bin", rays.cpu().numpy())
        done += 1
        if done % 500 == 0:
            print(f"  {done}/{len(image_dirs)}")
    print(f"Wrote {done} rays.bin files")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
