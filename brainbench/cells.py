"""Where the harness finds a cell's pieces, by the names in
`BENCHMARK.json`: the configuration file each `configs` entry names, the
traffic mix `traffic/<traffic>.json`, the limits of its output check
`limits/<cell>.json` and one reader per per-layer metric,
`metrics/<metric>.py`. A later cell, mix or metric is a new file and a new
entry; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


def _json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration file's contents
    traffic_name: str
    traffic: dict
    limits: dict          # check name -> limit
    end_to_end: list      # BENCHMARK.json entries reported with --trace 0
    per_layer: list       # entries reported with --trace 1


def is_training(traffic: dict) -> bool:
    """A training traffic names a subject bank (`subjects`, `bank_shape`),
    whatever its driver is called; every other traffic serves."""
    return "subjects" in traffic and "bank_shape" in traffic


def _for_cell(entries, cell):
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load(name: str, benchmark: str = BENCHMARK) -> Cell:
    """The cell `name` of `benchmark` (a BENCHMARK.json whose files lie
    under its directory); raises KeyError for an unknown one."""
    bench = _json(benchmark)
    root = os.path.dirname(os.path.abspath(benchmark))
    here = os.path.join(root, "brainbench")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=_json(os.path.join(root, conf["file"])),
                traffic_name=w["traffic"],
                traffic=_json(os.path.join(here, "traffic",
                                           f"{w['traffic']}.json")),
                limits=_json(os.path.join(here, "limits", f"{name}.json")),
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))


def metric_reader(name: str, here: str = HERE):
    """The `read(window)` function of `metrics/<name>.py` under `here`."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"brainbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
