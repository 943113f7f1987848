"""``python -m loftr_tpu_torch.train``: the training CLI (``train/cli.py``)."""
from loftr_tpu_torch.train.cli import main

main()
