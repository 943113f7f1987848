"""Training: optimizer and schedule, the trainer, checkpoints, and the CLI
(``python -m loftr_tpu_torch.train``, ``train/cli.py``)."""
