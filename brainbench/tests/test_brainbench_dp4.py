"""The data-parallel flagship cell `joint.train_dp4` at the harness's tiny
size on the CPU, where `tests/tiny.py` cuts its `ranks` to 2 gloo ranks
(spawned by the driver, each synthesizing its own items), and the readers
of its three metrics on a synthetic window."""

from __future__ import annotations

import pytest

from brainbench import cells, check
from brainbench.record import Spans, Window
from brainbench.tests.tiny import execute, tiny_cell
from brainbench.trace import Timeline
from brainfm_tpu_torch.utils import profiling

MS = 1_000_000   # ns


def test_the_cell_checks_every_ranks_items(monkeypatch):
    """`correct` over both ranks' items against the plain reference, two
    cards counted. The cell's limits are set for bf16 at full size, which
    a tiny bf16 step on the CPU passes even on one rank (`joint.train`'s
    `update_gap_median` reads 7e-3 there), so this run is in fp32: the
    mesh's arithmetic is then held to the cell's own limits."""
    kept = []
    gap = check.batch_gap
    monkeypatch.setattr(check, "batch_gap", lambda p, r: (
        kept.append((p["samples"]["input"].shape[0],
                     r["samples"]["input"].shape[0])), gap(p, r))[1])
    cell = tiny_cell("joint.train_dp4")
    cell.config["cfg"]["amp"] = False
    assert (cell.traffic["ranks"], cell.traffic["batch_items"]) == (2, 4)
    res = execute("joint.train_dp4", cell=cell)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= 4 and res["attempted"] % 4 == 0
    assert res["device"]["count"] == 2
    assert res["checks"]["batch_gap"]["value"] == 0.0
    assert kept == [(4, 4)] * 3        # the world's batch of each step


@pytest.fixture(autouse=True)
def _clean_records():
    profiling.clear()
    yield
    profiling.clear()


def _window(done=8, events=(), t0=0, t1=100 * MS, cfg=None, ranks=4):
    return Window(seconds=(t1 - t0) / 1e9, done=done, cfg=cfg or {},
                  traffic={"batch_items": 4, "ranks": ranks},
                  spans=Spans(False, None),
                  timeline=Timeline(list(events), t0, t1))


class _Timed:
    """A recorded span with a device time."""

    def __init__(self, name, t0, t1, ms):
        self.name, self.t0, self.t1, self._ms = name, t0, t1, ms

    def device_ms(self):
        return self._ms


@pytest.mark.parametrize("name,span", [
    ("reduce_ms.train_dp4", "step.reduce.grads"),
    ("rank_wait_ms.train_dp4", "step.reduce.wait")])
def test_reduce_readers_sum_their_spans_device_time_per_step(name, span):
    read = cells.metric_reader(name)
    assert read(_window()) is None
    for other in ("step.check", "step.reduce", "step.reduce.grads",
                  "step.reduce.wait"):
        if other != span:
            profiling.SPANS.append(_Timed(other, 0, 90 * MS, 50.0))
    assert read(_window()) is None                     # not its name
    for t0, ms in ((10, 3.0), (60, 5.0), (120, 7.0)):  # the last after t1
        profiling.SPANS.append(_Timed(span, t0 * MS, (t0 + 5) * MS, ms))
    profiling.SPANS.append(_Timed(span, 70 * MS, 75 * MS, None))  # untimed
    assert read(_window(done=8)) == pytest.approx((3.0 + 5.0) / 2)
    assert read(_window(done=3)) is None               # no whole step
    w = _window()
    w.timeline = None
    assert read(w) is None


def test_reduce_roofline_reads_the_bytes_over_the_gradient_spans():
    """Bytes over the device time of the gradient buckets' all-reduces
    alone: neither the losses' all-reduce, which holds the wait for the
    slowest rank, nor the rest of `step.reduce` counts."""
    read = cells.metric_reader("reduce_roofline.train_dp4")
    peak = 450e9
    with profiling.recording():
        profiling.count("reduce.bytes", int(peak * 0.004))
        profiling.count("reduce.bytes", int(peak * 0.004))
    t = profiling.EVENTS[0][0]
    w = _window(t0=t - MS, t1=t + 100 * MS)
    assert read(w) is None                             # nothing timed
    for name, t0, ms in (("step.reduce", 0, 80.0),
                         ("step.reduce.wait", 0, 60.0),
                         ("step.reduce.grads", 1, 4.0),
                         ("step.reduce.grads", 50, 6.0),
                         ("step.reduce.grads", 200, 9.0)):   # after t1
        profiling.SPANS.append(_Timed(name, t + t0 * MS, t + (t0 + 5) * MS,
                                      ms))
    assert read(w) == pytest.approx(100.0 * 0.008 / 0.010)
    profiling.EVENTS.clear()
    assert read(w) is None                             # nothing counted


def test_generator_readers_are_rank_0s_per_step():
    """`item_ms.train_dp4` and `gen_idle_ms.train_dp4` read rank 0's one
    item a step: `item_ms.train`'s and `gen_idle_ms.train`'s readings
    times the world's items a step (they divide by the world's items)."""
    for dp4, one in (("item_ms.train_dp4", "item_ms.train"),
                     ("gen_idle_ms.train_dp4", "gen_idle_ms.train")):
        four, base = cells.metric_reader(dp4), cells.metric_reader(one)
        busy = [("k", 10 * MS, 20 * MS), ("k", 40 * MS, 45 * MS)]
        w = _window(done=8, events=busy)
        w.spans = Spans(True, None)
        for s, e in ((0, 30), (35, 60)):
            w.spans.spans.append(("item", s * MS, e * MS))
            profiling.SPANS.append(_Timed("gen.item", s * MS, e * MS, None))
        assert base(w) > 0
        assert four(w) == pytest.approx(base(w) * 4)
        assert four(_window(done=3)) is None


def test_mfu_dp4_is_the_world_items_over_every_card():
    cfg = cells.load("joint.train_dp4").config["cfg"]
    one = cells.metric_reader("mfu.train")
    four = cells.metric_reader("mfu.train_dp4")
    for ranks in (2, 4):
        w = _window(done=40, cfg=cfg, ranks=ranks)
        assert four(w) == pytest.approx(one(w) / ranks)
    w = _window(done=0, cfg=cfg)
    assert four(w) is None


_KILL_A_RANK = """
import sys, time, torch
from brainbench.drivers import train as tr, train_dp4
from brainbench.tests.tiny import tiny_cell
cell = tiny_cell("joint.train_dp4")
subjects = tr.make_subjects(cell.traffic, 5, torch.device("cpu"))
prog = train_dp4.Program(cell.config["cfg"], cell.traffic, 5,
                         torch.device("cpu"), subjects)
prog.workers[0].kill()
time.sleep(120)     # as rank 0 would wait in a collective over NCCL
print("not reached", flush=True)
"""


def test_a_rank_that_dies_ends_the_run_at_once():
    """Rank 0 would wait for a dead rank in its next collective (over
    NCCL, until the collective's timeout): the driver's watch ends the
    process with exit code 1 at once instead."""
    import os
    import subprocess
    import sys
    import time

    root = os.path.dirname(cells.HERE)
    t = time.monotonic()
    p = subprocess.run([sys.executable, "-c", _KILL_A_RANK], cwd=root,
                       capture_output=True, text=True, timeout=240,
                       env=dict(os.environ, PYTHONPATH=root))
    assert p.returncode == 1, p.stderr[-3000:]
    assert time.monotonic() - t < 100
    assert "FATAL: rank 1 ended" in p.stderr
    assert "not reached" not in p.stdout


_RAISE_ON_RANK_0 = """
import multiprocessing, torch
from brainbench.drivers import train as tr, train_dp4
from brainbench.tests.tiny import tiny_cell
cell = tiny_cell("joint.train_dp4")
def failing(cell, seed, seconds, trace, device, clock, program, reference):
    dev = torch.device("cpu")
    program(cell.config["cfg"], cell.traffic, 5, dev,
            tr.make_subjects(cell.traffic, 5, dev))
    raise RuntimeError("planted")
tr.run = failing
try:
    train_dp4.run(cell, 5, 1.0, 0, "cpu", lambda: 0.0)
except RuntimeError as e:
    print("raised", e, multiprocessing.active_children(), flush=True)
"""


def test_an_error_on_rank_0_ends_the_other_ranks():
    """The other ranks would wait for rank 0 in their next collective:
    when rank 0 raises, the driver ends them (on the card it then ends
    the run with exit code 1; on the CPU it raises on)."""
    import os
    import subprocess
    import sys
    import time

    root = os.path.dirname(cells.HERE)
    t = time.monotonic()
    p = subprocess.run([sys.executable, "-c", _RAISE_ON_RANK_0], cwd=root,
                       capture_output=True, text=True, timeout=240,
                       env=dict(os.environ, PYTHONPATH=root))
    assert p.returncode == 0, p.stderr[-3000:]
    assert "raised planted []" in p.stdout, (p.stdout, p.stderr[-3000:])
    assert time.monotonic() - t < 100
