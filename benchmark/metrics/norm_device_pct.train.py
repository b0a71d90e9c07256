"""The norm layers' share of the training steps' time on the card: the
port's spans ``norm.fwd`` and ``norm.bwd`` (each ``apply_norm`` call,
casts included, and its backward) over its spans ``train.step``, summed
over the profiled stretch, in %."""

from benchmark.metrics.lib import program_spans


def read(run):
    return program_spans.norm_share_pct()
