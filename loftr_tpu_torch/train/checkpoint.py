"""Checkpoint save and restore on ``torch.save`` / ``torch.load``
(``loftr_tpu.train.checkpoint``).

A checkpoint holds the module's state_dict (parameters and running
statistics), the optimizer's, the step, the generator's state and any
half-accumulated gradients.  ``CheckpointManager`` keeps the best
``save_top_k`` checkpoints by a monitored metric (``auc@10``, larger is
better, as the reference's ModelCheckpoint) and can always restore the
latest of those it kept.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from loftr_tpu_torch.train.trainer import TrainState

_INDEX = "checkpoints.json"


def _state_payload(state: TrainState) -> dict:
    return {"step": state.step,
            "module": state.module.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "generator": state.generator.get_state(),
            "accum": state.accum}


def _load_payload(state: TrainState, payload: dict) -> TrainState:
    state.module.load_state_dict(payload["module"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.generator.set_state(payload["generator"].cpu())
    dev = next(state.module.parameters()).device
    state.accum = (None if payload["accum"] is None
                   else [a.to(dev) for a in payload["accum"]])
    state.step = int(payload["step"])
    return state


class CheckpointManager:
    def __init__(self, directory: str, save_top_k: int = 5,
                 monitor: str = "auc@10", mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(mode)
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.save_top_k = save_top_k
        self.monitor = monitor
        self.mode = mode
        self._metrics: Dict[int, float] = {}
        index = os.path.join(directory, _INDEX)
        if os.path.exists(index):
            with open(index) as f:
                self._metrics = {int(k): v for k, v in json.load(f).items()}

    def path(self, step: int) -> str:
        """The file of checkpoint ``step``."""
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def _score(self, step: int) -> float:
        worst = -float("inf") if self.mode == "max" else float("inf")
        v = self._metrics[step]
        v = worst if v is None else v
        return v if self.mode == "max" else -v

    def save(self, step: int, state: TrainState,
             metrics: Optional[dict] = None) -> None:
        tmp = self.path(step) + ".tmp"
        torch.save(_state_payload(state), tmp)
        os.replace(tmp, self.path(step))
        self._metrics[step] = (metrics or {}).get(self.monitor)
        # keep the best save_top_k (ties: the later step)
        keep = sorted(self._metrics, key=lambda s: (self._score(s), s),
                      reverse=True)[:self.save_top_k]
        for s in list(self._metrics):
            if s not in keep:
                del self._metrics[s]
                if os.path.exists(self.path(s)):
                    os.remove(self.path(s))
        with open(os.path.join(self.directory, _INDEX), "w") as f:
            json.dump({str(k): v for k, v in self._metrics.items()}, f)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load checkpoint ``step`` (default: the latest kept) into
        ``state`` in place; returns it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        dev = next(state.module.parameters()).device
        payload = torch.load(self.path(step), map_location=dev,
                             weights_only=False)
        return _load_payload(state, payload)

    def latest_step(self) -> Optional[int]:
        return max(self._metrics) if self._metrics else None


def save_params(path: str, module: torch.nn.Module) -> None:
    """Parameters and running statistics only (a library checkpoint)."""
    torch.save(module.state_dict(), path)


def load_params(path: str, module: Optional[torch.nn.Module] = None):
    """The saved state_dict, loaded into ``module`` when one is given."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if module is not None:
        module.load_state_dict(sd)
    return sd
