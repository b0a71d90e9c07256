"""The median host time the trainer's feed takes to hand over a batch
(``next`` on ``DevicePipeline``, the benchmark's span ``feed``) over the
window, in ms."""


def read(run):
    return run.spans.median_ms("feed")
