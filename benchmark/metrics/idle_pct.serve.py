"""The share of the profiled requests' wall time in which nothing
ran on the card, in %."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
