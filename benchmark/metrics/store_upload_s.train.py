"""The host's time to build the trainer's store on the card (the port's
set-up span ``setup.store``: the host's gather or encode of the pack's
rows and their copies to the card), in s."""

from benchmark.metrics.lib import program_spans


def read(run):
    return program_spans.setup_s("setup.store")
