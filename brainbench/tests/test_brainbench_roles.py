"""A training cell is known by its traffic's role, not by its driver's
name: the tiny cut, the limit readings and the device count follow the
driver's own parts. A cell whose driver brings its own program and
reference goes in as new files, run in a copy of the harness."""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest

from brainbench import cells, control, run
from brainbench.record import Outcome, Spans, Window
from brainbench.tests.tiny import shrink

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 12345678901

TRAIN_B = '''"""A training driver that brings its own parts."""
import sys

from . import train


def say(msg):
    print(f"# train_b {msg}", file=sys.stderr, flush=True)


class Program(train.Program):
    def __init__(self, cfg_tree, traffic, seed, device, subjects):
        say(f"subjects {len(subjects)} extent "
            f"{[int(s) for s in subjects[0]['shape']]}")
        super().__init__(cfg_tree, traffic, seed, device, subjects)

    def make_step(self, model, cfg, wdict, loss_fn, opt):
        from brainfm_tpu_torch.train.step import make_train_step

        say("step")
        return make_train_step(
            model, cfg, wdict, loss_fn, opt,
            sample_accum=int(cfg.get("grad_accum_samples") or 1))


def build_model(cfg, device):
    say("reference")
    return train.REFERENCE.build_model(cfg, device)


PROGRAM = Program
REFERENCE = train.Reference(build_model, train.REFERENCE.apply_processors,
                            train.REFERENCE.make_criterion)


def run(cell, seed, seconds, trace, device, clock):
    return train.run(cell, seed, seconds, trace, device, clock, PROGRAM,
                     REFERENCE)
'''


@pytest.mark.parametrize("name,driver,ranks", [
    ("joint.train", "train", None), ("joint.train", "train_b", 4),
    ("sep.train", "train_dp4", 1), ("joint.serve", "train", None)])
def test_shrink_cuts_a_traffic_by_its_role(name, driver, ranks):
    cell = cells.load(name)
    cell.traffic["driver"] = driver
    if ranks is not None:
        cell.traffic["ranks"] = ranks
    t = shrink(cell).traffic
    if name.endswith(".train"):
        assert cells.is_training(t)
        assert (t["subjects"], t["extent"], t["bank_shape"]) == (
            2, [40, 40, 40], [48, 48, 48])
        assert "inputs" not in t
        assert t.get("ranks") == (None if ranks is None else min(ranks, 2))
    else:
        assert not cells.is_training(t)
        assert (t["inputs"], t["win"]) == (2, [40, 40, 40])


def _stub_driver(monkeypatch, name, devices):
    def stub_run(cell, seed, seconds, trace, device, clock):
        w = Window(seconds=1.0, done=1, cfg={}, traffic=cell.traffic,
                   spans=Spans(False, lambda: None))
        return Outcome(end_to_end={m["name"]: 1.0 for m in cell.end_to_end},
                       window=w, attempted=1, failed=0, memory_peak_bytes=0,
                       devices=devices)

    mod = types.ModuleType(f"brainbench.drivers.{name}")
    mod.run = stub_run
    monkeypatch.setitem(sys.modules, mod.__name__, mod)


@pytest.mark.parametrize("devices", [1, 4])
def test_execute_reports_the_drivers_device_count(monkeypatch, devices):
    _stub_driver(monkeypatch, "stub_devices", devices)
    cell = copy.deepcopy(cells.load("joint.train"))
    cell.traffic["driver"] = "stub_devices"
    cell.limits = {}
    res = run.execute(cell, SEED, 0.1, 0, "cpu", time.time())
    assert res["device"]["count"] == devices
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("name,driver,side", [
    ("joint.train", "train_b", "train"), ("sep.train", "train", "train"),
    ("joint.serve", "train", "serve")])
def test_control_dispatches_by_role(monkeypatch, name, driver, side):
    seen = []
    monkeypatch.setattr(control, "train_readings",
                        lambda *a: seen.append("train") or [])
    monkeypatch.setattr(control, "serve_readings",
                        lambda *a: seen.append("serve") or [])
    cell = cells.load(name)
    cell.traffic["driver"] = driver
    control.readings(cell, SEED, "cpu", False, 1)
    assert seen == [side]


@pytest.fixture(scope="module")
def copy_with_train_b(tmp_path_factory):
    """A copy of the harness with a configuration, a traffic whose driver
    is the new module `train_b`, limits and a cell added as files."""
    root = tmp_path_factory.mktemp("co")
    shutil.copytree(os.path.join(ROOT, "brainbench"), root / "brainbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "brainbench"
    conf = json.load(open(b / "configs" / "joint.json"))
    conf["name"] = "joint_b"
    (b / "configs" / "joint_b.json").write_text(json.dumps(conf))
    traffic = json.load(open(b / "traffic" / "train.json"))
    traffic["driver"] = "train_b"
    (b / "traffic" / "train_b.json").write_text(json.dumps(traffic))
    (b / "limits" / "joint_b.train_b.json").write_text(
        (b / "limits" / "joint.train.json").read_text())
    (b / "drivers" / "train_b.py").write_text(TRAIN_B)
    bench = json.load(open(cells.BENCHMARK))
    bench["configs"].append(dict(bench["configs"][0], name="joint_b",
                                 file="brainbench/configs/joint_b.json"))
    bench["workloads"].append({"name": "joint_b.train_b", "config": "joint_b",
                               "traffic": "train_b", "chips": 1,
                               "why": "a training cell with its own driver"})
    for m in bench["end_to_end"]:
        if "joint.train" in m.get("workloads", []):
            m["workloads"].append("joint_b.train_b")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _in_copy(root, code):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), ROOT]))
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


def test_a_training_cell_of_its_own_driver_runs_as_new_files(
        copy_with_train_b):
    here = os.path.join(ROOT, "brainbench")
    for d, dirs, files in os.walk(here):      # every harness file as it is
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), here)
            with open(os.path.join(d, f), "rb") as a, \
                    open(copy_with_train_b / "brainbench" / rel, "rb") as b:
                assert a.read() == b.read(), rel
    res, err = _in_copy(copy_with_train_b, (
        "import json\nfrom brainbench.tests.tiny import execute\n"
        "print(json.dumps(execute('joint_b.train_b')))"))
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == set(cells.load("joint.train").limits)
    assert res["device"]["count"] == 1
    assert set(res["metrics"]) == {"setup_s", "train_items_per_s"}
    assert "# train_b subjects 2 extent [40, 40, 40]" in err
    assert "# train_b step" in err and "# train_b reference" in err


def test_control_reads_a_training_cell_with_its_drivers_parts(
        copy_with_train_b):
    rows, err = _in_copy(copy_with_train_b, (
        "import json, torch\nfrom brainbench import control\n"
        "from brainbench.tests.tiny import tiny_cell\n"
        "print(json.dumps(control.readings(tiny_cell('joint_b.train_b'), "
        f"{SEED}, torch.device('cpu'), False, 1)))"))
    assert [r["side"] for r in rows] == ["program"]
    assert set(cells.load("joint.train").limits) <= set(rows[0])
    assert "# train_b subjects 2 extent [40, 40, 40]" in err
    assert "# train_b step" in err and "# train_b reference" in err
