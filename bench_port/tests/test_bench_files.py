"""Every cell, configuration, traffic mix and metric that BENCHMARK.json
names is found by name under bench_port/, and the file keeps to the
benchmark's contract."""
import json
import os
import re

import pytest

from bench_port import core

ROOT = os.path.dirname(core.HERE)
B = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "bench_port/run.py"]
    assert B["paths"] == ["bench_port"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    assert NAME.match(w["name"]) and w["chips"] == 1
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    cell = core.load_cell(w["name"])
    assert cell.workload["config"] == w["config"]
    assert cell.workload["traffic"] == w["traffic"]
    assert cell.mix["generator"] in ("offline", "train")
    assert cell.limits, "a cell compares at least one number"
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_configuration_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"] == f"bench_port/configs/{c['name']}.json"
    cfg = json.load(open(os.path.join(ROOT, c["file"])))
    assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    assert all(NAME.match(k) for k in c["reduced"])
    assert cfg["widths"]["block_dims"] == [128, 196, 256]
    assert any(w["config"] == c["name"] for w in B["workloads"])


def test_metrics_have_readers_and_cells():
    readers = core.metric_readers()
    cells = {w["name"] for w in B["workloads"]}
    e2e = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in e2e
    for m in B["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock",
                                                         "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] in readers, m["name"]
        assert readers[m["name"]].UNIT == m["unit"]
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            moved = next(x for x in B["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", cells)
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    layers = {m["layer"] for m in B["per_layer"]}
    assert all(len(x) <= 200 and "\n" not in x for x in layers)


def test_every_cell_reports_a_per_layer_metric():
    for w in B["workloads"]:
        assert any(w["name"] in m["workloads"] for m in B["per_layer"])
