"""The host's time to build the trainer's model, loss, optimizer and
steps (the port's set-up span ``setup.model``), in s."""

from benchmark.metrics.lib import program_spans


def read(run):
    return program_spans.setup_s("setup.model")
