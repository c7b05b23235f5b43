"""Training: configuration, the training step and epoch loop, checkpoints."""
