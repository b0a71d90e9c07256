"""The card's median time of a data-parallel training step's gradient
all-reduce (the port's span ``train.allreduce``: one flat NCCL
all-reduce of every gradient, its flattening and copies back) over the
profiled stretch of rank 0, in ms. None where the port records no such
span (one card, or a port without it)."""

from benchmark.metrics.lib import program_spans


def read(run):
    return program_spans.step_median_ms("train.allreduce")
