"""cadepth_tpu_torch — the PyTorch and CUDA port of ``cadepth_tpu``.

The JAX package beside it stays the reference. This package serves the
flagship ``GeometryAwareNetwork`` through :class:`~cadepth_tpu_torch.
inference.Predictor` on an NVIDIA H100 and trains it through
``training.train_state.make_train_step``; the Perspective Correction
Layer's two-pass affine warp, forward and backward, is CUDA for
``sm_90a`` (``csrc/two_pass_warp.cu``), built with ``nvcc`` at first use.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version instead.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
