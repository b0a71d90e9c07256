"""Evaluation CLI of the port (the flags of ``cli/evaluate.py``):

    python -m cadepth_tpu_torch.cli.evaluate --checkpoint <dir>|best|latest \
        --config <yaml> [--output results/] [--num-vis 8] \
        [--colormap viridis] [--no-vis] [--save-predictions] \
        [--max-samples N] [--batch-size N] [--device cuda|cpu]

``--device`` (default ``cuda``) takes the place of the JAX CLI's
``--platform``. The checkpoint is one the port's trainer wrote
(``training/checkpoint.py``); a JAX run's goes through
``cadepth_tpu_torch.convert.train_state_to_torch`` first. With
``data.device_resident`` and ``data.packed_dir`` the sweep reads the pack
held in device memory (``data/device_resident.py``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Camera-aware depth evaluation (PyTorch)")
    p.add_argument("--checkpoint", required=True,
                   help="Checkpoint directory or 'best'/'latest' relative "
                        "to the config's checkpoint_dir")
    p.add_argument("--config", default="configs/train_config.yaml")
    p.add_argument("--experiment", default="")
    p.add_argument("--output", default="./evaluation_results")
    p.add_argument("--num-vis", type=int, default=8)
    p.add_argument("--colormap", default="viridis")
    p.add_argument("--no-vis", action="store_true")
    p.add_argument("--save-predictions", action="store_true")
    p.add_argument("--max-samples", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=0,
                   help="Eval batch size (0 = reference default of 1)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Where to evaluate (cuda raises without a card)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import numpy as np
    import torch

    from cadepth_tpu_torch.config import load_config
    from cadepth_tpu_torch.data.sunrgbd import SunRGBDLoader
    from cadepth_tpu_torch.evaluation.evaluator import (EvaluationConfig,
                                                        ModelEvaluator)
    from cadepth_tpu_torch.models.factory import resolve_device
    from cadepth_tpu_torch.training.checkpoint import CheckpointManager
    from cadepth_tpu_torch.training.train_state import (build_model_and_loss,
                                                        device_batch)
    from cadepth_tpu_torch.visualization.depth_viz import create_comparison

    device = resolve_device(args.device)
    cfg = load_config(args.config, experiment=args.experiment or None)
    model, _ = build_model_and_loss(cfg, device=device)

    loader_kw = dict(
        split=cfg.data.val_split,
        target_height=cfg.data.input_height, target_width=cfg.data.input_width,
        allowed_sensors=cfg.data.sensor_types or
        ["kv1", "kv2", "realsense", "xtion"],
        split_filtering=cfg.data.split_filtering,
        compute_rays=cfg.data.compute_rays,
        rays_on_device=cfg.data.compute_rays)
    if cfg.data.packed_dir:
        from cadepth_tpu_torch.data.packed import PackedSunRGBDLoader

        loader = PackedSunRGBDLoader(cfg.data.packed_dir,
                                     preload=cfg.data.packed_preload,
                                     **loader_kw)
    else:
        loader = SunRGBDLoader(cfg.data.data_dir, cfg.data.manifest_path,
                               **loader_kw)

    ckpt_root = Path(cfg.checkpointing.checkpoint_dir) / cfg.experiment.name
    mgr = CheckpointManager(str(ckpt_root))
    try:
        ckpt_path = mgr.resolve(args.checkpoint)
    except FileNotFoundError as exc:
        print(f"No checkpoint: {exc}", file=sys.stderr)
        return 1
    state, meta = mgr.restore_with_meta(ckpt_path, device)
    model.load_state_dict(state["model"])
    print(f"Loaded checkpoint {ckpt_path} (epoch {meta.get('epoch', '?')})")

    evaluator = ModelEvaluator(cfg, model, EvaluationConfig(
        min_depth=cfg.validation.min_depth,
        max_depth=cfg.validation.max_depth,
        batch_size=args.batch_size or 1,
        colormap=args.colormap))
    result = evaluator.evaluate(
        loader, max_samples=args.max_samples or None,
        device_resident=bool(cfg.data.device_resident and
                             cfg.data.packed_dir))

    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    report = ModelEvaluator.report(result, cfg.model.architecture)
    print(report)
    (out_dir / "report.txt").write_text(report)
    ModelEvaluator.write_csv(result, str(out_dir / "per_sample_metrics.csv"))
    ModelEvaluator.write_summary_csv(result, str(out_dir / "summary_metrics.csv"))

    def predict(batch):
        return evaluator.predict_fn(device_batch(batch, device)).float() \
            .cpu().numpy()

    if not args.no_vis and args.num_vis > 0:
        import cv2

        from cadepth_tpu_torch.metrics.depth_metrics import (
            compute_depth_metrics_per_sample,
        )
        from cadepth_tpu_torch.visualization.depth_viz import (
            create_comprehensive_visualization,
        )

        vis_dir = out_dir / "visualizations"
        vis_dir.mkdir(exist_ok=True)
        # uniform sampling over the dataset (evaluate_main.cpp:156-209)
        n = min(args.num_vis, len(loader))
        idx = np.linspace(0, len(loader) - 1, n).astype(int)
        batch = loader.get_batch(idx)
        pred = predict(batch)
        per_sample = {
            k: v.numpy() for k, v in compute_depth_metrics_per_sample(
                torch.from_numpy(pred), torch.from_numpy(batch["depth"]),
                min_depth=cfg.validation.min_depth,
                max_depth=cfg.validation.max_depth).items()}
        for j in range(n):
            rgb_j, gt_j = batch["rgb"][j], batch["depth"][j]
            panel = create_comparison(rgb_j, gt_j, pred[j],
                                      colormap=args.colormap)
            cv2.imwrite(str(vis_dir / f"comparison_{j:03d}.png"),
                        cv2.cvtColor(panel, cv2.COLOR_RGB2BGR))
            # per-sample report image (depth_visualizer.h:259-290 /
            # evaluate_main.cpp:156-209)
            full = create_comprehensive_visualization(
                rgb_j, gt_j, pred[j],
                {k: float(v[j]) for k, v in per_sample.items()},
                min_depth=cfg.validation.min_depth,
                max_depth=cfg.validation.max_depth, colormap=args.colormap)
            cv2.imwrite(str(vis_dir / f"comprehensive_{j:03d}.png"),
                        cv2.cvtColor(full, cv2.COLOR_RGB2BGR))
        print(f"Saved {n} visualizations to {vis_dir}")

    if args.save_predictions:
        pred_dir = out_dir / "predictions"
        pred_dir.mkdir(exist_ok=True)
        from cadepth_tpu_torch.visualization.depth_viz import save_depth_image

        n = min(result.num_samples, len(loader))
        chunk = max(args.batch_size or 1, 1)
        saved = 0
        for start in range(0, n, chunk):
            preds = predict(loader.get_batch(range(start,
                                                   min(start + chunk, n))))
            for j in range(preds.shape[0]):
                save_depth_image(
                    str(pred_dir / f"pred_{start + j:04d}.png"), preds[j],
                    colormap=args.colormap,
                    min_depth=0.0, max_depth=cfg.validation.max_depth)
                saved += 1
        print(f"Saved {saved} predictions to {pred_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
