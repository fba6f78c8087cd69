"""The readers of the two-stage cell's per-layer metrics on a synthetic
window: `stage0_ms.serve` and `stage1_ms.serve` sum the device timings of
the program's stage spans that start in the window, over the volumes, and
stay silent without a timeline, without device timings or with a program
whose spans have none; `mfu.serve_twostage` counts both stages."""

from __future__ import annotations

import types

import pytest

from brainbench import cells, flops, flops_twostage
from brainbench.record import Spans, Window
from brainbench.trace import Timeline
from brainfm_tpu_torch.utils import profiling

MS = 1_000_000   # ns


@pytest.fixture(autouse=True)
def _clean_records():
    profiling.clear()
    yield
    profiling.clear()


class _Event:
    """A CUDA event's stand-in: `at` ms on the stream."""

    def __init__(self, at):
        self.at = at

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


def stage(name, t0, t1, device_ms=None):
    s = profiling.Span(name, False)
    s.t0, s.t1 = t0, t1
    if device_ms is not None:
        s._events = (None, _Event(1.0), _Event(1.0 + device_ms))
    profiling.SPANS.append(s)
    return s


def window(done=2, timeline=True, seconds=0.1, cfg=None, traffic=None):
    tl = Timeline([], 0, 100 * MS) if timeline else None
    return Window(seconds=seconds, done=done, cfg=cfg or {},
                  traffic=traffic or {}, spans=Spans(False, None),
                  timeline=tl)


@pytest.mark.parametrize("i", [0, 1])
def test_stage_ms_sums_the_device_timings_in_the_window(i):
    read = cells.metric_reader(f"stage{i}_ms.serve")
    name, other = f"serve.stage{i}", f"serve.stage{1 - i}"
    assert read(window()) is None                        # nothing recorded
    stage(other, 10 * MS, 20 * MS, device_ms=7.0)
    stage(name, 20 * MS, 30 * MS)                        # no device timing
    assert read(window()) is None
    stage(name, 30 * MS, 40 * MS, device_ms=12.5)
    stage(name, 95 * MS, 110 * MS, device_ms=4.0)        # starts inside
    stage(name, -5 * MS, 5 * MS, device_ms=100.0)        # starts before
    stage(name, 100 * MS, 120 * MS, device_ms=100.0)     # starts at the end
    assert read(window(done=2)) == pytest.approx((12.5 + 4.0) / 2)
    assert read(window(timeline=False)) is None
    assert read(window(done=0)) is None


def test_stage_ms_is_silent_for_a_program_without_device_timing():
    """The parent's spans: a name and host times, no `device_ms`."""
    profiling.SPANS.append(types.SimpleNamespace(name="serve.stage0",
                                                 t0=10 * MS, t1=20 * MS))
    assert cells.metric_reader("stage0_ms.serve")(window()) is None


def test_mfu_counts_both_stages():
    cfg = cells.load("twostage.serve").config["cfg"]
    win = [220, 220, 220]
    w = window(done=3, seconds=2.0, cfg=cfg, traffic={"win": win})
    want = 100.0 * flops_twostage.forward_flops(cfg, win) * 3 / 2.0 \
        / flops.PEAK_BF16_FLOPS
    assert cells.metric_reader("mfu.serve_twostage")(w) == pytest.approx(
        want)
    assert 6.0 < want < 6.3      # 40.95 TFLOP x 1.5 vols/s of 989 TFLOP/s
    assert cells.metric_reader("mfu.serve_twostage")(window(done=0)) is None
