"""The card's median time of a training step's update (the port's span
``train.update``: the gradient's norm, max and min, clipping and the
optimizer) over the profiled stretch, in ms."""

from benchmark.metrics.lib import program_spans


def read(run):
    return program_spans.step_median_ms("train.update")
