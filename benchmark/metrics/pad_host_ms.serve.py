"""The host's median time to build a request's batch (the port's span
``serve.pad``: the padding to the batch, K, k4) over the profiled
stretch, in ms."""

from benchmark.metrics.lib import program_spans


def read(run):
    return program_spans.median_ms("serve.pad", device=False)
