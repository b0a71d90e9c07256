"""The card's median time of a request's forward (the port's span
``serve.forward``: rays from K and the model in evaluation mode) over the
profiled stretch, in ms."""

from benchmark.metrics.lib import program_spans


def read(run):
    return program_spans.median_ms("serve.forward", device=True)
