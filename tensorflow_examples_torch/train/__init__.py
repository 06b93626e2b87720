"""Training: config, optimizers, state, task and the loop."""
