"""Training: the train, gradient, eval and inference steps, the optimizer
and the learning-rate schedule, checkpoints, TensorBoard logging and the
``Trainer`` loop."""
