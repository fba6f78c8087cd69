"""Profiling and tracing hooks (port of brainfm_tpu/utils/profiling.py):
a `torch.profiler` trace, named regions, device-memory counters, a
synchronizing step timer and a per-call device clock."""

from __future__ import annotations

import contextlib
import os
import time

import torch

from ..device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block on the CPU and, when CUDA is present, the card; the
    Chrome trace `trace_<pid>_<n>.json` is written into `log_dir` (open it
    in chrome://tracing or Perfetto). Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{n}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region in a trace (`record_function`), and an NVTX range
    when CUDA is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
