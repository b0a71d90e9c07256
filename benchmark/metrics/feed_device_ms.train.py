"""The card's median time a training step's batch takes to be drawn
(the port's span ``train.feed``: ``next`` on the trainer's feed, the
gather and augmentation on the card) over the profiled stretch, in ms."""

from benchmark.metrics.lib import program_spans


def read(run):
    return program_spans.step_median_ms("train.feed")
