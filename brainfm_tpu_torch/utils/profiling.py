"""Profiling and tracing hooks (port of brainfm_tpu/utils/profiling.py):
the program's spans and counters, a `torch.profiler` trace that carries
them, device-memory counters, a synchronizing step timer and a per-call
device clock.

Spans and counters. `annotate(name)` is a span around a stage of the
program and `count(name, n)` adds to a counter. They are recorded in
memory (`SPANS`, `COUNTS`, `EVENTS`) only while recording is on: inside
`recording()`, or while a `torch.profiler` session records (the
module-level `torch.autograd.profiler._is_profiler_enabled`, which every
thread sees). Each start of a recording clears them. Off, a span or a
counter is one flag check: nothing is recorded, allocated or entered. On,
a span reads `time.time_ns()` (the clock of the profiler's device events)
at either end and enters a `record_function` range of its name. Neither
state synchronizes the card or reads a device value.

A span's parent is the span open on its thread when it opens;
`within(span)` makes a span the parent on another thread (the
prefetch and writer threads of `Inferencer.evaluate_path`). `unit=True`
starts a unit of work (a generated item, a served volume): the span takes
a new id and every span below it inherits it.

`annotate(name, device=dev)` on a CUDA `dev` also times the span on the
card: on, it records a CUDA event on the device's current stream at the
span's start and at its end, and `Span.device_ms()` resolves the pair
once the work is done (after the measured window: it waits for the second
event). Recording an event does not synchronize. Off, it is the same one
flag check; on another device the span has no device time.

The spans and counters (see PERF.md for the metrics that read them):
  serve.volume > serve.read, serve.prepare, serve.forward, serve.fetch,
      serve.write                                    (infer/)
  serve.forward > serve.stage0, serve.stage1: the two stages of a served
      two-stage pair, each timed on the card         (models/build.py)
  gen.item > gen.setup, gen.deform, gen.synth, gen.targets > gen.pathology
      > gen.shape | gen.lesion_warp, gen.advect; gen.sample (synth/)
  step > step.forward, step.backward, step.check, step.update (train/)
  host_syncs: each blocking wait of the host on the card on the training
      and serving path; ode.steps, ode.rejected, ode.evals, ode.nt: the
      adaptive solver's steps (rejected ones included), rejected steps,
      right-hand-side evaluations and requested intervals (ops/ode.py);
      write.chunks: the chunks of a .nii.gz deflated on the writer's
      thread pool (utils/nifti.py; a one-chunk file adds nothing);
      layout.copies: each copy the port makes of an activation or a
      gradient to change its memory format (NCDHW against NDHWC: the
      GroupNorm kernels' mixed operands, ops/groupnorm.py; the network's
      boundaries, models/), 0 where the network keeps one layout.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _tap

from ..device import resolve_device

SPANS: list = []      # every Span opened while recording, in opening order
COUNTS: dict = {}     # counter name -> total
EVENTS: list = []     # (time_ns, counter name, n) of each count()
_forced = 0           # depth of recording() blocks
_local = threading.local()
_lock = threading.Lock()
_units = itertools.count(1)


class _Off:
    """What a span is while recording is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def open(self):
        return self

    def close(self):
        pass


OFF = _Off()


class Span:
    """One recorded span: `name`, `t0`/`t1` (time.time_ns), `parent` (a
    Span or None), `unit` (the id of its item or volume, or None) and
    `tid` (the native id of the thread that opened it); with a CUDA
    `device`, the pair of CUDA events that `device_ms()` reads."""
    __slots__ = ("name", "t0", "t1", "parent", "unit", "tid", "_new",
                 "_prev", "_rf", "_events")

    def __init__(self, name, unit, device=None):
        self.name, self._new = name, unit
        self.t0 = self.t1 = self.unit = self.parent = None
        self._prev = self._rf = None
        self._events = None
        dev = None if device is None else torch.device(device)
        if dev is not None and dev.type == "cuda":
            self._events = (dev, torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def open(self):
        """Start the span without making it the thread's parent (a span
        that another thread closes)."""
        self.parent = getattr(_local, "span", None)
        self.unit = (next(_units) if self._new else
                     self.parent.unit if self.parent is not None else None)
        self.tid = threading.get_native_id()
        SPANS.append(self)
        self.t0 = time.time_ns()
        self._record(1)
        return self

    def close(self):
        self._record(2)
        self.t1 = time.time_ns()

    def _record(self, i):
        """Record the start (1) or end (2) event on the current stream."""
        if self._events is not None:
            self._events[i].record(torch.cuda.current_stream(
                self._events[0]))

    def device_ms(self):
        """Milliseconds of the card's stream between the span's start and
        end, or None for a span without device timing or not yet closed.
        Waits for the end event: read it after the measured work."""
        if self._events is None or self.t1 is None:
            return None
        _, start, end = self._events
        end.synchronize()
        return start.elapsed_time(end)

    def __enter__(self):
        self.open()
        self._prev = getattr(_local, "span", None)
        _local.span = self
        self._rf = _tap.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        _local.span = self._prev
        self.close()
        return False


class _Within:
    __slots__ = ("span", "prev")

    def __init__(self, span):
        self.span = span

    def __enter__(self):
        self.prev = getattr(_local, "span", None)
        _local.span = self.span

    def __exit__(self, *exc):
        _local.span = self.prev
        return False


def annotate(name: str, unit: bool = False, device=None):
    """A span named `name` around the block (or, with `.open()` and
    `.close()`, across threads), under the span open on this thread;
    `unit=True` starts a new unit of work; a CUDA `device` times it on
    that card's current stream too. Off: `OFF`."""
    if not (_forced or _tap._is_profiler_enabled):
        return OFF
    return Span(name, unit, device)


def within(span):
    """The block's spans on this thread take `span` as their parent."""
    if span is OFF or span is None:
        return OFF
    return _Within(span)


def count(name: str, n: int = 1):
    """Add n to the counter `name` (and log it with the time)."""
    if not (_forced or _tap._is_profiler_enabled):
        return
    with _lock:
        COUNTS[name] = COUNTS.get(name, 0) + n
        EVENTS.append((time.time_ns(), name, n))


def clear():
    with _lock:
        SPANS.clear()
        COUNTS.clear()
        EVENTS.clear()


def _clear_then(start):
    def run_on_profiler_start():
        clear()
        start()
    return run_on_profiler_start


# a profiler session's start is a recording's start: it clears the records
if hasattr(_tap, "_run_on_profiler_start"):
    _tap._run_on_profiler_start = _clear_then(_tap._run_on_profiler_start)


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block (cleared at its start);
    read `SPANS`, `COUNTS` and `EVENTS` afterwards."""
    global _forced
    clear()
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def _chrome_events(base_ns: int) -> list:
    """The recorded spans as complete events and the counters as counter
    events of the Chrome trace format, at microseconds since `base_ns`,
    under the process "program"."""
    pid = "program"

    def us(t):
        return (t - base_ns) / 1e3

    ids = {id(s): i for i, s in enumerate(SPANS)}
    out = [{"ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": "brainfm_tpu_torch spans and counters"}}]
    for i, s in enumerate(SPANS):
        if s.t1 is None:
            continue
        out.append({"ph": "X", "cat": "program", "name": s.name,
                    "pid": pid, "tid": s.tid, "ts": us(s.t0),
                    "dur": (s.t1 - s.t0) / 1e3,
                    "args": {"span": i, "unit": s.unit,
                             "parent": ids.get(id(s.parent))}})
    totals: dict = {}
    for t, name, n in sorted(EVENTS):
        totals[name] = totals.get(name, 0) + n
        out.append({"ph": "C", "cat": "program", "name": name, "pid": pid,
                    "ts": us(t), "args": {name: totals[name]}})
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block on the CPU and, when CUDA is present, the card; the
    Chrome trace `trace_<pid>_<n>.json` is written into `log_dir` (open it
    in chrome://tracing or Perfetto), with the program's spans and counters
    of the block on the trace's own time base, as the process "program".
    Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(_chrome_events(
        int(doc.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(doc, f)


def device_memory_stats(device=None) -> dict:
    """Device memory under the JAX package's keys: `bytes_in_use` and
    `peak_bytes_in_use` (PyTorch's allocator: allocated bytes now and at
    their peak) and `bytes_limit` (the card's total memory). CUDA unless
    `device` says otherwise; another device has no counters and gives
    zeros."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev)
                           .total_memory),
    }


class StepTimer:
    """Wall-clock step timer whose first `warmup` steps are discarded.
    `stop` first waits for the card (`torch.cuda.synchronize`) when CUDA is
    present, so queued work counts; `result` is taken for the JAX
    package's signature (it waits on the result)."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._n = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        del result
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self):
        return sum(self.times) / max(len(self.times), 1)


def call_times(fn, device, reps: int, warmup: int = 1) -> list[float]:
    """ms of each of `reps` calls of fn() after `warmup` untimed ones. On a
    CUDA `device`: a pair of CUDA events around each call, the calls
    queued back to back and the events read after one synchronize, so a
    call's launch overlaps the one before it; the host clock elsewhere."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return times
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize(dev)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize(dev)
    return [start.elapsed_time(end) for start, end in events]
