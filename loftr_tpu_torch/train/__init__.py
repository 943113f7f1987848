"""Training: optimizer and schedule, the trainer, checkpoints."""
