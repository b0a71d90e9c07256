"""Kernels the card runs a training step (the feed's gather and
augmentation, forward, loss, backward, optimizer), counted in the
profile's window."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.kernels() / run.trace.steps
