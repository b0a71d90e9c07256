"""Command-line entry points: ``python -m cadepth_tpu_torch.cli.train``
and ``python -m cadepth_tpu_torch.cli.evaluate``."""
