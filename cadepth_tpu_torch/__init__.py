"""cadepth_tpu_torch — the PyTorch and CUDA port of ``cadepth_tpu``.

The JAX package beside it stays the reference. This package serves the
flagship ``GeometryAwareNetwork`` through :class:`~cadepth_tpu_torch.
inference.Predictor` on an NVIDIA H100 and trains it through its
``Trainer`` (``training/trainer.py``) on SUN RGB-D-style data fed by the
host input pipeline (``data/``), with checkpoints, resume, TensorBoard
and the evaluator; ``python -m cadepth_tpu_torch.cli.train`` and
``.evaluate`` are its entry points. Every Pallas kernel of the JAX
package has a hand-written CUDA kernel for ``sm_90a`` under ``csrc/``,
built with ``nvcc`` at first use.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version instead.
"""

from cadepth_tpu_torch.version import __version__

__all__ = ["__version__"]
