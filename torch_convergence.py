#!/usr/bin/env python3
"""The convergence protocol of ``scripts/convergence_demo.sh``, run
through the PyTorch port's train CLI.

    python3 torch_convergence.py [workdir] [--arch geometry_aware]
                                 [--epochs 120] [--seed 7]
                                 [--device cuda|cpu]

The same data and configuration as the shell script: the structured
synthetic set (60 scenes a sensor at 128x96, seed 9, written by the
port's generator), split by hash, experiment seed 7 (``--seed``: the
weights, the shuffle and the augmentation; the data stay those of seed
9), init_features 16, AdamW at
5e-4 with a cosine schedule and 2 warmup epochs, batch 16, flips and
colour jitter, no early stopping. It prints the final and the best
validation abs_rel, rmse and delta1 from metrics.csv, and the card's
name and power limit, on the last line as JSON.
"""

from __future__ import annotations

import argparse
import csv
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("workdir", nargs="?",
                    default=str(ROOT / "build" / "convergence"))
    ap.add_argument("--arch", default="geometry_aware")
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--seed", type=int, default=7,
                    help="experiment.seed: the weights, the shuffle and "
                         "the augmentation")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from cadepth_tpu_torch.cli import train as train_cli
    from cadepth_tpu_torch.data.synthetic import generate_synthetic_dataset

    work = pathlib.Path(args.workdir).absolute()
    work.mkdir(parents=True, exist_ok=True)
    manifest = generate_synthetic_dataset(
        str(work), images_per_sensor=60, seed=9, structured=True,
        sensor_specs={s: (128, 96, 128, 96)
                      for s in ("kv1", "kv2", "realsense", "xtion")})
    name = f"convergence_demo_{args.arch}"
    if args.seed != 7:
        name += f"_seed{args.seed}"
    config = work / f"{name}.yaml"
    config.write_text(f"""\
experiment: {{name: "{name}", seed: {args.seed}}}
data:
  data_dir: "{work}/sunrgbd"
  manifest_path: "{manifest}"
  input_height: 96
  input_width: 128
  split_filtering: true
  compute_rays: true
  augmentation: {{random_crop: false, horizontal_flip: true, color_jitter: true}}
model: {{architecture: "{args.arch}", init_features: 16}}
optimization:
  optimizer: "adamw"
  learning_rate: 5.0e-4
  lr_scheduler: "cosine"
  lr_warmup_epochs: 2
training: {{num_epochs: {args.epochs}, batch_size: 16, num_workers: 4, log_interval: 5, num_vis_samples: 2}}
checkpointing: {{checkpoint_dir: "{work}/ckpts", save_interval: 10}}
logging: {{log_dir: "{work}/logs"}}
early_stopping: {{enabled: false}}
""")
    t0 = time.perf_counter()
    rc = train_cli.main(["--config", str(config), "--device", args.device])
    wall = time.perf_counter() - t0
    if rc != 0:
        return rc
    rows = list(csv.DictReader((work / "logs" / name / "metrics.csv").open()))
    val = [r for r in rows if float(r["abs_rel"]) > 0]
    best = min(val, key=lambda r: float(r["abs_rel"]))
    last = rows[-1]
    card = "cpu"
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    out = {"arch": args.arch, "seed": args.seed, "epochs": len(rows),
           "card": card,
           "wall_s": wall,
           "final": {k: float(last[k]) for k in ("abs_rel", "rmse", "a1")},
           "best": {"abs_rel": float(best["abs_rel"]),
                    "rmse": float(best["rmse"]), "a1": float(best["a1"]),
                    "epoch": int(float(best["epoch"])) + 1}}
    print(f"Final: abs_rel={out['final']['abs_rel']:.4f} "
          f"rmse={out['final']['rmse']:.4f} delta1={out['final']['a1']:.4f}")
    print(f"Best:  abs_rel={out['best']['abs_rel']:.4f} @ epoch "
          f"{out['best']['epoch']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
