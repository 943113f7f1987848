"""Structured metrics logging (rank-zero, JSONL + optional TensorBoard); a
copy of ``loftr_tpu.utils.logging``.

Replaces the reference's loguru/TensorBoard stack (misc.py:31-40,
train.py:89-98, lightning_loftr.py:116-131): metric scalars stream as JSONL
lines with the same keys as the JAX package's, ``step`` and ``time``
(seconds since the logger started) first, and, when enabled, mirror into
TensorBoard event files (``tensorboard=True``; ``torch.utils.tensorboard``).
Match-visualization figures (``utils/plotting.py``) save as PNGs and also
mirror into TB.  Everything is muted off rank 0; the rank is
``torch.distributed``'s when a process group is initialised, else 0.
Converting a scalar with ``float`` reads it from the device, so a caller
that logs every N steps synchronises every N steps only.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Mapping, Optional

import torch


def process_rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, echo: bool = True,
                 name: str = "metrics", tensorboard: bool = False):
        self.enabled = process_rank() == 0
        self.echo = echo
        self._fh: Optional[IO] = None
        self._tb = None
        self._t0 = time.time()
        if self.enabled and log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(
                        log_dir=os.path.join(log_dir, "tb"))
                except Exception as e:  # TB deps are optional
                    print(f"[logging] TensorBoard writer unavailable: {e}",
                          file=sys.stderr)
        self.log_dir = log_dir

    def log(self, step: int, scalars: Mapping[str, float], **extra) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": round(time.time() - self._t0, 2),
               **{k: float(v) for k, v in scalars.items()}, **extra}
        line = json.dumps(rec)
        if self.echo:
            print(line, flush=True)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def log_figures(self, step: int, figures, prefix: str = "match") -> None:
        """Save matplotlib figures (utils/plotting output) as PNGs (and
        mirror to TensorBoard when enabled)."""
        if not self.enabled or not self.log_dir:
            return
        import matplotlib.pyplot as plt
        fig_dir = os.path.join(self.log_dir, "figures")
        os.makedirs(fig_dir, exist_ok=True)
        for i, fig in enumerate(figures):
            fig.savefig(os.path.join(
                fig_dir, f"{prefix}_step{step:08d}_{i}.png"),
                bbox_inches="tight")
            if self._tb is not None:
                self._tb.add_figure(f"{prefix}/{i}", fig, int(step),
                                    close=False)
            plt.close(fig)

    def close(self):
        if self._fh:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()
