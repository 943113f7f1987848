"""PyTorch port: ``utils/logging.MetricsLogger`` against the JAX package's.

For the same scalars (tensors on the port's side) both write the same
JSONL records (``time`` aside), echo the same lines, name figure files
alike, print the same one-line warning when TensorBoard is missing, and
write nothing off rank 0.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from loftr_tpu.utils.logging import MetricsLogger as JaxLogger
from loftr_tpu_torch.utils import logging as tlog

SCALARS = {"loss": 1.5, "loss_c": 0.25, "loss_f": 1.25, "grad_norm": 3.0,
           "lr": 2e-3}


def _records(path):
    recs = [json.loads(ln) for ln in open(path)]
    for r in recs:
        assert isinstance(r.pop("time"), float)
    return recs


@pytest.mark.parametrize("extra", [{"epoch": 0}, {"epoch": 3, "phase": "val"},
                                   {}])
def test_jsonl_records_match_jax(tmp_path, capsys, extra):
    jl = JaxLogger(log_dir=str(tmp_path / "jax"))
    tl = tlog.MetricsLogger(log_dir=str(tmp_path / "port"))
    for step in (1, 50):
        jl.log(step, {k: np.float32(v) for k, v in SCALARS.items()},
               **extra)
        jax_line = capsys.readouterr().out
        tl.log(step, {k: torch.tensor(v) for k, v in SCALARS.items()},
               **extra)
        port_line = capsys.readouterr().out
        j, t = json.loads(jax_line), json.loads(port_line)
        j.pop("time"), t.pop("time")
        assert list(t) == list(j) and t == j
    jl.close(), tl.close()
    got = _records(tmp_path / "port" / "metrics.jsonl")
    want = _records(tmp_path / "jax" / "metrics.jsonl")
    assert got == want and len(got) == 2
    assert list(got[0])[:1] == ["step"]


def test_figures_are_named_like_jax(tmp_path):
    import matplotlib.pyplot as plt
    names = {}
    for name, cls in (("jax", JaxLogger), ("port", tlog.MetricsLogger)):
        lg = cls(log_dir=str(tmp_path / name), echo=False)
        lg.log_figures(7, [plt.figure(), plt.figure()], prefix="val")
        lg.close()
        names[name] = sorted(os.listdir(tmp_path / name / "figures"))
    assert names["port"] == names["jax"] == [
        "val_step00000007_0.png", "val_step00000007_1.png"]


def test_missing_tensorboard_warns_like_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    JaxLogger(log_dir=str(tmp_path / "jax"), tensorboard=True).close()
    jax_err = capsys.readouterr().err
    tlog.MetricsLogger(log_dir=str(tmp_path / "port"),
                       tensorboard=True).close()
    port_err = capsys.readouterr().err
    assert port_err == jax_err
    assert port_err.startswith("[logging] TensorBoard writer unavailable:")
    assert port_err.count("\n") == 1


def test_silent_off_rank_zero(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    assert tlog.process_rank() == 1
    for name, cls in (("jax", JaxLogger), ("port", tlog.MetricsLogger)):
        lg = cls(log_dir=str(tmp_path / name))
        assert not lg.enabled
        lg.log(1, SCALARS)
        lg.close()
    assert capsys.readouterr().out == ""
    assert not os.listdir(tmp_path)


def test_rank_without_process_group():
    assert not torch.distributed.is_initialized()
    assert tlog.process_rank() == 0
