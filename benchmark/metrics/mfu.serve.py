"""The forward's share of the card's peak: the window's images a
second times the forward FLOPs an image (the
reference network counted on the meta device), over 989 TFLOP/s (bf16,
dense) or 67 TFLOP/s (float32), in %."""

from benchmark.metrics.lib.roofline import peak_flops


def read(run):
    flops = getattr(run, "flops_per_image", None)
    if not flops:
        return None
    return 100.0 * run.images_per_s * flops / peak_flops(run.use_amp)
