"""The DPT head's share of the training steps' card time: the port's
spans ``dpt.head`` and ``dpt.head.bwd`` (its backward, from the depth's
gradient down to its four token maps') over its spans ``train.step``,
summed over the profiled stretch, in %. None without those spans."""

from benchmark.metrics.lib.step_share import share_pct


def read(run):
    return share_pct(("dpt.head", "dpt.head.bwd"))
