"""The card's median time of a training step's backward (the port's
span ``train.backward``) over the profiled stretch, in ms."""

from benchmark.metrics.lib import program_spans


def read(run):
    return program_spans.step_median_ms("train.backward")
