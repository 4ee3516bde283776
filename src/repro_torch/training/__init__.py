"""Training: optimizers, checkpoints and the Stage-1 / Stage-2 loops."""
