"""Training: the train, gradient, eval and inference steps, the optimizer
and the learning-rate schedule."""
