"""What a traffic driver (drivers/) hands back: the measured window, the
harness's spans and the numbers of the output check."""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


class Spans:
    """The harness's own spans around its calls into the program: with
    `enabled` each span synchronizes the device before it reads the host
    clock at either end (only the traced run does this), else it records
    nothing and costs nothing."""

    def __init__(self, enabled: bool, sync):
        self.enabled = enabled
        self.sync = sync
        self.spans = []          # (name, t0_ns, t1_ns), time.time_ns clock

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.enabled:
            yield
            return
        self.sync()
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.sync()
            self.spans.append((name, t0, time.time_ns()))

    def seconds(self, name) -> float:
        return sum(b - a for n, a, b in self.spans if n == name) / 1e9


@dataclass
class Window:
    """The measured window as the per-layer readers see it."""
    seconds: float            # host length of the window
    done: int                 # units completed in it (items or volumes)
    cfg: dict                 # the configuration tree
    traffic: dict
    spans: Spans
    timeline: object = None   # trace.Timeline of the traced run, else None


@dataclass
class Outcome:
    end_to_end: dict          # metric name -> value
    window: Window
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: dict = field(default_factory=dict)   # name -> measured value
    devices: int = 1          # the cards the run used (`device.count`)
