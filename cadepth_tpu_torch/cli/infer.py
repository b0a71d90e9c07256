"""Single-image depth inference with the port (the flags of
``cli/infer.py``):

    python -m cadepth_tpu_torch.cli.infer --checkpoint best \
        --config configs/train_config.yaml --image path/to/rgb.jpg \
        [--intrinsics path/to/intrinsics.txt] [--output out_dir] \
        [--colormap viridis] [--save-npy] [--export depth.pt2] \
        [--device cuda|cpu]

Loads a checkpoint of the port's trainer through
``Predictor.from_checkpoint`` (a JAX run's goes through
``cadepth_tpu_torch.convert.train_state_to_torch`` first), resizes the
image to the config's input size (scaling K with it), predicts, and
writes a 16-bit depth PNG in millimetres (the SUN RGB-D convention) at
the image's own size, a colormapped PNG and, with ``--save-npy``, the
depth in metres as ``.npy``. ``--device`` (default ``cuda``) takes the
place of the JAX CLI's ``--platform``, and ``--export`` (a
``torch.export`` program of the batch-1 predictor, read back by
``cadepth_tpu_torch.inference.load_exported``) that of
``--export-stablehlo``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Single-image depth inference "
                                            "(PyTorch)")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint dir, or 'best'/'latest'")
    p.add_argument("--config", default="configs/train_config.yaml")
    p.add_argument("--experiment", default="")
    p.add_argument("--image", required=True, help="RGB image path")
    p.add_argument("--intrinsics", default="",
                   help="intrinsics.txt (9 floats); defaults to a centered "
                        "pinhole with f = image width")
    p.add_argument("--output", default="./inference_out")
    p.add_argument("--colormap", default="viridis")
    p.add_argument("--save-npy", action="store_true")
    p.add_argument("--export", default="",
                   help="Also write the (batch-1) inference program with "
                        "its parameters to this path (torch.export; read "
                        "it back with cadepth_tpu_torch.inference."
                        "load_exported)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Where to predict (cuda raises without a card)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import cv2
    import numpy as np

    from cadepth_tpu_torch.config import load_config
    from cadepth_tpu_torch.geometry.io import load_intrinsics_txt
    from cadepth_tpu_torch.inference import Predictor
    from cadepth_tpu_torch.training.checkpoint import (META_FILE,
                                                       CheckpointManager)
    from cadepth_tpu_torch.visualization.depth_viz import save_depth_image

    cfg = load_config(args.config, experiment=args.experiment or None)

    bgr = cv2.imread(args.image, cv2.IMREAD_COLOR)
    if bgr is None:
        print(f"Cannot read image: {args.image}", file=sys.stderr)
        return 1
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    h0, w0 = rgb.shape[:2]

    if args.intrinsics:
        k = load_intrinsics_txt(args.intrinsics)
    else:
        k = np.array([[w0, 0, w0 / 2.0], [0, w0, h0 / 2.0], [0, 0, 1]],
                     np.float32)
        print(f"No intrinsics given; assuming f={w0}px centered pinhole")

    th, tw = cfg.data.input_height, cfg.data.input_width
    rgb_r = cv2.resize(rgb, (tw, th), interpolation=cv2.INTER_LINEAR)
    sx, sy = tw / w0, th / h0
    k = k.copy()
    k[0, 0] *= sx
    k[1, 1] *= sy
    k[0, 2] *= sx
    k[1, 2] *= sy

    ckpt_root = Path(cfg.checkpointing.checkpoint_dir) / cfg.experiment.name
    try:
        ckpt_path = CheckpointManager(str(ckpt_root)).resolve(args.checkpoint)
    except FileNotFoundError as exc:
        print(f"No checkpoint: {exc}", file=sys.stderr)
        return 1
    predictor = Predictor.from_checkpoint(cfg, ckpt_path, batch_size=1,
                                          device=args.device)
    meta_path = Path(ckpt_path) / META_FILE
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    print(f"Loaded checkpoint {ckpt_path} (epoch {meta.get('epoch', '?')})")

    depth = predictor.predict(rgb_r[None], k[None].astype(np.float32))[0]
    # back to the input resolution, nearest (no depth mixing)
    depth_full = cv2.resize(depth[..., 0], (w0, h0),
                            interpolation=cv2.INTER_NEAREST)

    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    stem = Path(args.image).stem
    cv2.imwrite(str(out / f"{stem}_depth.png"),
                np.clip(depth_full * 1000.0, 0, 65535).astype(np.uint16))
    save_depth_image(str(out / f"{stem}_depth_vis.png"), depth_full,
                     colormap=args.colormap, min_depth=0.0,
                     max_depth=cfg.model.max_depth)
    if args.save_npy:
        np.save(out / f"{stem}_depth.npy", depth_full)
    print(f"Depth: min={depth_full.min():.2f}m max={depth_full.max():.2f}m "
          f"mean={depth_full.mean():.2f}m")
    print(f"Wrote {out}/{stem}_depth.png (16-bit mm) and {stem}_depth_vis.png")

    if args.export:
        nbytes = predictor.export(args.export)
        print(f"Exported torch.export program ({nbytes / 2**20:.1f} MiB) "
              f"to {args.export}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
