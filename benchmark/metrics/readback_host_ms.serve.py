"""The host's median time to read a request's depth back from the card
(the port's span ``serve.readback``: the wait for its forward and the
copy) over the profiled stretch, in ms."""

from benchmark.metrics.lib import program_spans


def read(run):
    return program_spans.median_ms("serve.readback", device=False)
