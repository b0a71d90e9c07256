"""The card's median time of a training step's loss (the port's span
``train.loss``: the combined depth loss's forward) over the profiled
stretch, in ms."""

from benchmark.metrics.lib import program_spans


def read(run):
    return program_spans.step_median_ms("train.loss")
