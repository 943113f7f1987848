"""Shared pieces of the harness: finding a cell's files by name, the import
guard, the card's identity and the result line."""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
# top-level module names no run may load: JAX, its libraries and the JAX
# package the port was made from (whole names: loftr_tpu_torch is allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "loftr_tpu")


def forbidden_loaded(names) -> List[str]:
    """The names in ``names`` whose top-level module is forbidden."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload.get("limits", {})


def load_cell(name: str) -> Cell:
    """A cell's workload file, and the configuration and traffic mix it
    names, each found by name under ``bench_port/``."""
    w = load_json("workloads", name + ".json")
    return Cell(name, w, load_json("configs", w["config"] + ".json"),
                load_json("traffic", w["traffic"] + ".json"))


def load_reader(path: str):
    """A metric reader module from its file (names hold dots)."""
    name = "bench_port_metric_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers() -> Dict[str, object]:
    """Every per-layer metric reader, by metric name (its file name)."""
    d = os.path.join(HERE, "metrics")
    return {f[:-3]: load_reader(os.path.join(d, f))
            for f in sorted(os.listdir(d))
            if f.endswith(".py") and not f.startswith("_")}


def power_limit() -> str:
    """``name, power.limit`` of the card as nvidia-smi prints them, or
    ``unknown``."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() \
            else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


@dataclass
class Check:
    """One number compared with the reference and its limit (the number
    passes while it is at most the limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Result:
    attempted: int
    failed: int
    metrics: Dict[str, dict] = field(default_factory=dict)
    device: dict = field(default_factory=dict)
    checks: List[Check] = field(default_factory=list)
    readings: Dict[str, object] = field(default_factory=dict)
    breakdown: Optional[dict] = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) \
            and self.failed == 0

    def line(self) -> str:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics,
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                         for c in self.checks}
        return json.dumps(out)


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)
