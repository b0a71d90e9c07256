"""The host's median time to copy a request's batch to the card (the
port's span ``serve.h2d``) over the profiled stretch, in ms."""

from benchmark.metrics.lib import program_spans


def read(run):
    return program_spans.median_ms("serve.h2d", device=False)
