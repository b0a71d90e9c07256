"""The median host time the predictor takes to stage a request
(``Predictor._make_batch``: padding, K to k4, the copies to the card;
the benchmark's span ``stage``) over the window, in ms."""


def read(run):
    return run.spans.median_ms("stage")
