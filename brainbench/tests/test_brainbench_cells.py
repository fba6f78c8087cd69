"""Every cell through the harness on the CPU at a tiny size, the result
line's keys, the refusal without a card, and the files found by name."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from brainbench import cells
from brainbench.tests.tiny import execute

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(open(cells.BENCHMARK))["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_gives_the_contract_keys(name):
    res = execute(name)
    assert set(res) == KEYS
    assert list(res)[-1] == "checks"
    cell = cells.load(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == set(cell.limits)
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(res)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics(name):
    """On the CPU there is no device trace: the span and clock readers
    report, the trace readers stay silent."""
    res = execute(name, trace=1)
    cell = cells.load(name)
    names = {m["name"] for m in cell.per_layer}
    assert set(res["metrics"]) <= names
    for m in cell.per_layer:
        if m["source"] == "host_clock":
            assert m["name"] in res["metrics"], m["name"]
        else:
            assert m["name"] not in res["metrics"], m["name"]


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "brainbench.run",
                        "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, limits and a metric added as files
    and entries, with no file of the harness edited."""
    root = tmp_path / "co"
    shutil.copytree(os.path.join(ROOT, "brainbench"), root / "brainbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(cells.BENCHMARK))
    b = root / "brainbench"
    conf = json.load(open(b / "configs" / "joint.json"))
    conf["name"] = "joint_b"
    (b / "configs" / "joint_b.json").write_text(json.dumps(conf))
    traffic = json.load(open(b / "traffic" / "train.json"))
    traffic["subjects"] = 3
    (b / "traffic" / "train_b.json").write_text(json.dumps(traffic))
    (b / "limits" / "joint_b.train_b.json").write_text(
        (b / "limits" / "joint.train.json").read_text())
    (b / "metrics" / "items.new.py").write_text(
        "def read(w):\n    return float(w.done)\n")
    bench["configs"].append(dict(bench["configs"][0], name="joint_b",
                                 file="brainbench/configs/joint_b.json"))
    bench["workloads"].append({"name": "joint_b.train_b", "config": "joint_b",
                               "traffic": "train_b", "chips": 1,
                               "why": "a later cell"})
    bench["per_layer"].append({"name": "items.new", "unit": "items",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole", "moves": "setup_s",
                               "workloads": ["joint_b.train_b"]})
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = cells.load("joint_b.train_b", str(path))
    assert cell.config["name"] == "joint_b"
    assert cell.traffic["subjects"] == 3
    assert [m["name"] for m in cell.per_layer] == ["items.new"]
    read = cells.metric_reader("items.new", str(b))
    assert read(type("W", (), {"done": 7})()) == 7.0
