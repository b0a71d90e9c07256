"""The card's median time of a training step's forward (the port's
span ``train.forward``: rays from K and the model in training mode) over
the profiled stretch, in ms."""

from benchmark.metrics.lib import program_spans


def read(run):
    return program_spans.step_median_ms("train.forward")
