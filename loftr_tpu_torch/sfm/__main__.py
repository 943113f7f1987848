"""``python -m loftr_tpu_torch.sfm``: the SfM CLI (``sfm/cli.py``)."""
from loftr_tpu_torch.sfm.cli import main

main()
