"""Training CLI of the port (the flags of ``cli/train.py``):

    python -m cadepth_tpu_torch.cli.train --config configs/train_config.yaml \
        [--experiment geometry_aware_full] [--resume latest|<path>] \
        [--debug] [--tensorboard true|false] [--devices N] \
        [--profile] [--nan-check] [--device cuda|cpu] [--multihost]

``--device`` (default ``cuda``) takes the place of the JAX CLI's
``--platform``; without a card, ``cuda`` raises. ``--multihost`` joins
the process group first (``parallel.initialize_distributed``) and trains
data-parallel, one process a card; launch it on every card with

    torchrun --nproc-per-node N -m cadepth_tpu_torch.cli.train \
        --config configs/train_config.yaml --multihost

(``--device cpu`` trains N processes over Gloo on the CPU). With
``hardware.spatial_parallel: S`` in the config, the N processes form
N / S data rows of S ranks (JAX's data x space mesh): each row takes
``training.batch_size / (N / S)`` samples of a global batch, and each of
its S ranks a band of ``data.input_height / S`` rows of those images
(``parallel.make_mesh_2d``). N must divide by S, the batch by N / S and
the height by S, else the trainer raises.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Camera-aware depth training (PyTorch)")
    p.add_argument("--config", default="configs/train_config.yaml",
                   help="Path to YAML config")
    p.add_argument("--experiment", default="",
                   help="Named experiment override block")
    p.add_argument("--resume", default="",
                   help="'latest' or a checkpoint path")
    p.add_argument("--debug", action="store_true",
                   help="Tiny run for debugging")
    p.add_argument("--tensorboard", default="true", choices=["true", "false"],
                   help="Enable TensorBoard event writing")
    p.add_argument("--devices", type=int, default=0,
                   help="Number of devices for data parallelism (0 = all)")
    p.add_argument("--profile", action="store_true",
                   help="Capture a torch.profiler trace of the first epoch")
    p.add_argument("--nan-check", action="store_true",
                   help="Enable autograd anomaly detection (slow)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Where to train (cuda raises without a card)")
    p.add_argument("--multihost", action="store_true",
                   help="Join the torch.distributed process group "
                        "(torchrun's or COORDINATOR_ADDRESS/NUM_PROCESSES/"
                        "PROCESS_ID) and train data-parallel (and "
                        "spatially, with hardware.spatial_parallel)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    joined = False
    if args.multihost:
        # before anything touches a card: it picks this process's card
        from cadepth_tpu_torch.parallel import initialize_distributed

        joined = initialize_distributed(
            backend="gloo" if args.device == "cpu" else None)

    from cadepth_tpu_torch.config import load_config
    from cadepth_tpu_torch.training.trainer import Trainer

    cfg = load_config(args.config, experiment=args.experiment or None,
                      debug=args.debug)
    if args.resume:
        cfg.checkpointing.resume_from = args.resume
    if args.tensorboard == "false":
        cfg.logging.tensorboard_enabled = False
    if args.devices:
        cfg.hardware.num_devices = args.devices

    np.random.seed(cfg.experiment.seed)
    print(f"torch {torch.__version__}, device: {args.device}"
          + (f" ({torch.cuda.get_device_name(0)})"
             if args.device == "cuda" and torch.cuda.is_available() else ""))

    if args.nan_check:
        from cadepth_tpu_torch.utils.profiling import enable_nan_debugging

        enable_nan_debugging()

    try:
        trainer = Trainer(cfg, device=args.device)
        try:
            if args.profile:
                # traces the FIRST training epoch in place (no extra epoch
                # that would advance the optimizer/LR schedule before the
                # real run)
                trainer.profile_dir = str(trainer.log_dir / "profile")
            metrics = trainer.train()
        finally:
            trainer.close()
    finally:
        if joined:
            dist.destroy_process_group()
    if metrics:
        from cadepth_tpu_torch.metrics.depth_metrics import format_metrics

        print(format_metrics(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
