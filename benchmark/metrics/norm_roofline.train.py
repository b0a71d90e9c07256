"""The training batch norms' share of their memory roofline: the bytes
the step's 22 norm maps need (each map read once and written once
forward; the output's gradient and the map read once and the input's
gradient written once backward; counted from the reference network's
shapes, ``lib/norm_bytes.py``) at 3.35 TB/s, over the card's time of the
port's spans ``norm.fwd`` and ``norm.bwd`` in a training step (median
over the profiled stretch's steps), in %. It counts the same work
whatever implements the norms; None for a configuration whose network
the count does not cover."""

from benchmark.metrics.lib import program_spans, roofline
from benchmark.metrics.lib.norm_bytes import norm_bytes


def read(run):
    device_ms = program_spans.step_median_ms(("norm.fwd", "norm.bwd"))
    if not device_ms:
        return None
    nbytes = norm_bytes(run.conf["config"], 2 if run.use_amp else 4)
    if nbytes is None:
        return None
    return 100.0 * roofline.bound_s(nbytes) * 1e3 / device_ms
