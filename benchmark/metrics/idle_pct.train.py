"""The share of the profiled training steps' wall time in which nothing
ran on the card, in %."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
