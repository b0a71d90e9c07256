"""The median host time a call into the trainer's step takes to return
(``Trainer.train_step``, no wait for the card; the benchmark's span
``step``) over the window, in ms."""


def read(run):
    return run.spans.median_ms("step")
