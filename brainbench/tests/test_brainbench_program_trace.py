"""The readers of the program's spans and counters
(brainbench/metrics/<name>.py, source program_span / program_counter) on
a synthetic window: the spans and counts of
brainfm_tpu_torch/utils/profiling.py laid over a device timeline, each
reader's value, its clipping to the window, and no reading without a
timeline or without the names it reads."""

from __future__ import annotations

import pytest

from brainbench import cells
from brainbench.record import Spans, Window
from brainbench.trace import Timeline
from brainfm_tpu_torch.utils import profiling

MS = 1_000_000   # ns


@pytest.fixture(autouse=True)
def _clean_records():
    profiling.clear()
    yield
    profiling.clear()


def span(name, t0, t1):
    s = profiling.Span(name, False)
    s.t0, s.t1 = t0, t1
    profiling.SPANS.append(s)
    return s


def window(done=2, events=(), t0=0, t1=100 * MS, batch_items=1):
    tl = Timeline(list(events), t0, t1)
    return Window(seconds=(t1 - t0) / 1e9, done=done, cfg={},
                  traffic={"batch_items": batch_items},
                  spans=Spans(False, None), timeline=tl)


SPAN_READERS = {"read_ms.serve": "serve.read",
                "prepare_ms.serve": "serve.prepare",
                "fetch_ms.serve": "serve.fetch",
                "write_ms.serve": "serve.write"}


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_stage_ms_sums_its_spans_in_the_window(metric):
    name = SPAN_READERS[metric]
    read = cells.metric_reader(metric)
    assert read(window()) is None                      # nothing recorded
    span("serve.volume", 0, 90 * MS)
    span("serve.forward" if name != "serve.forward" else "other",
         10 * MS, 20 * MS)
    assert read(window()) is None                      # not its name
    span(name, 20 * MS, 30 * MS)
    span(name, 95 * MS, 110 * MS)                      # clipped at t1
    span(name, -5 * MS, -1 * MS)                       # before the window
    assert read(window(done=3)) == pytest.approx((10 + 5) / 3)
    w = window()
    w.timeline = None                                  # the untraced run
    assert read(w) is None


@pytest.mark.parametrize("metric,name,units", [
    ("gen_idle_ms.train", "gen.item", 2),
    ("step_idle_ms.train", "step", 1)])
def test_idle_inside_the_spans(metric, name, units):
    """Busy 0-10, 20-30 and 35-100 ms; the spans 5-40 and 90-120 ms hold
    the idle 10-20 and 30-35 ms (and nothing past t1)."""
    read = cells.metric_reader(metric)
    busy = [("k", 0, 10 * MS), ("k", 20 * MS, 25 * MS),
            ("k", 24 * MS, 30 * MS), ("k", 35 * MS, 100 * MS)]
    assert read(window(events=busy)) is None
    span("other", 0, 100 * MS)
    assert read(window(events=busy)) is None
    span(name, 5 * MS, 40 * MS)
    span(name, 90 * MS, 120 * MS)
    got = read(window(done=2, events=busy, batch_items=2 // units))
    assert got == pytest.approx(15 / units)
    # without the last kernel the idle runs to t1 = 110 ms: the spans
    # (5-40, 90-110 and 100-110 after clipping) hold 10-20, 30-40, 90-110
    span(name, 100 * MS, 130 * MS)
    got = read(window(done=2, events=busy[:3], t1=110 * MS,
                      batch_items=2 // units))
    assert got == pytest.approx((10 + 10 + 20) / units)


def test_host_syncs_per_iteration_in_the_window():
    read = cells.metric_reader("host_syncs.train")
    assert read(window()) is None
    profiling.EVENTS.extend([(-1, "host_syncs", 7), (5 * MS, "host_syncs", 3),
                             (6 * MS, "ode.steps", 9),
                             (50 * MS, "host_syncs", 2),
                             (101 * MS, "host_syncs", 40)])
    assert read(window(done=4, batch_items=2)) == pytest.approx(5 / 2)
    profiling.EVENTS[:] = [(6 * MS, "ode.steps", 9)]
    assert read(window()) is None


def test_ode_steps_per_item_in_the_window():
    read = cells.metric_reader("ode_steps.train")
    profiling.EVENTS.extend([(5 * MS, "ode.steps", 30),
                             (7 * MS, "host_syncs", 30),
                             (60 * MS, "ode.steps", 12),
                             (120 * MS, "ode.steps", 99)])
    assert read(window(done=3)) is None               # no generator spans
    span("gen.item", 0, 10 * MS)
    assert read(window(done=3)) == pytest.approx(42 / 3)
    profiling.EVENTS[:] = [(5 * MS, "host_syncs", 1)]
    assert read(window(done=3)) == 0.0               # no pathology item
    span("gen.item", 200 * MS, 210 * MS)
    w = window(done=3)
    w.timeline = None
    assert read(w) is None


def test_the_records_of_a_program_without_them():
    """A program whose recorder keeps no SPANS or EVENTS (the parent's):
    every reader returns None and raises nothing."""
    saved = profiling.SPANS, profiling.EVENTS
    try:
        del profiling.SPANS, profiling.EVENTS
        for m in list(SPAN_READERS) + ["gen_idle_ms.train",
                                       "step_idle_ms.train",
                                       "host_syncs.train", "ode_steps.train"]:
            assert cells.metric_reader(m)(window()) is None, m
    finally:
        profiling.SPANS, profiling.EVENTS = saved
