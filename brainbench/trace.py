"""The traced run's device timeline: `torch.profiler` over the measured
window, reduced to kernel records, the device's busy time, its idle gaps
and the breakdown the result line carries.

Only CUDA activity is recorded (kernels, copies, sets), which keeps a
51 s window of a train step's thousands of launches readable in seconds.
The events are read from the profiler's kineto results directly; their
timestamps are Unix nanoseconds, the clock of `time.time_ns()`, so the
harness's own spans (recorded on that clock) name what the host was doing
in each idle gap.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from .record import log

# kernel families for the breakdown, first match (from the repo's
# scripts/profile_torch_slice.py FAMILIES)
GN_OWN = ("sums_kernel", "sums_finish", "affine_kernel", "affine3_kernel")
OWN = ("warp_linear_kernel", "warp_nearest_kernel", "lut_row_kernel",
       "lut_word_kernel", "lut_scalar_kernel") + GN_OWN
FAMILIES = (("gn_sums", ("sums_kernel", "sums_finish")),
            ("gn_affine", ("affine_kernel",)),
            ("gn_affine3", ("affine3_kernel",)),
            ("groupnorm_fwd", ("RowwiseMoments", "ComputeFusedParams")),
            ("groupnorm_bwd", ("ComputeInternalGradients",
                               "ComputeBackwardFusedParams", "GammaBeta",
                               "GroupNormBackward")),
            ("conv_dgrad", ("dgrad",)),
            ("conv_wgrad", ("wgrad",)),
            ("conv_fwd", ("fprop", "conv", "xmma", "implicit_gemm")),
            ("optimizer", ("multi_tensor_apply", "foreach", "Adam")),
            ("own_kernels", OWN),
            ("index_add", ("indexFunc",)),
            ("layout", ("nchwToNhwc", "nhwcToNchw")),
            ("copy_cast", ("copy_kernel",)),
            ("memcpy", ("Memcpy", "memcpy")),
            ("elementwise", ("elementwise_kernel", "reduce_kernel")))
TOP = 10


@dataclass
class Timeline:
    """Device events of the traced window: (name, start_ns, end_ns)."""
    events: list
    t0_ns: int
    t1_ns: int
    spans: list = field(default_factory=list)   # (name, t0_ns, t1_ns)

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_intervals(self):
        """The union of the events' intervals, clipped to the window."""
        out = []
        for _, a, b in sorted(self.events, key=lambda e: e[1]):
            a, b = max(a, self.t0_ns), min(b, self.t1_ns)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def seconds_of(self, names) -> float:
        """Summed device seconds of the events whose name holds any of
        `names`."""
        return sum(b - a for n, a, b in self.events
                   if any(k in n for k in names)) / 1e9

    def device_ops(self, top=TOP):
        tot = {}
        for n, a, b in self.events:
            fam = next((f for f, keys in FAMILIES
                        if any(k in n for k in keys)), None)
            key = n[:100] if fam is None else fam
            tot[key] = tot.get(key, 0) + (b - a)
        ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v / 1e9] for k, v in ranked]

    def idle_gaps(self, top=TOP):
        """The longest idle gaps, each named by the harness span the host
        was in at its middle ('between' outside every span)."""
        busy = self.busy_intervals()
        edges = [self.t0_ns] + [x for ab in busy for x in ab] + [self.t1_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])

        def what(t):
            inner = [s for s in self.spans if s[1] <= t < s[2]]
            return min(inner, key=lambda s: s[2] - s[1])[0] if inner \
                else "between"

        return [[what((a + b) // 2), (b - a) / 1e9] for a, b in gaps[:top]]


def _device_events(prof):
    """(name, start_ns, end_ns) of every CUDA-side event."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        if hasattr(e, "start_ns"):
            a, d = e.start_ns(), e.duration_ns()
        else:
            a, d = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), int(a), int(a + d)))
    return out


@contextlib.contextmanager
def device_trace(enabled: bool):
    """Profile CUDA activity inside the block when `enabled`; yields a
    holder whose `.events` are filled once the block ends."""
    holder = type("Trace", (), {"events": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield holder
    t = time.perf_counter()
    holder.events = _device_events(prof)
    log(f"trace: {len(holder.events)} device events read in "
        f"{time.perf_counter() - t:.2f} s")
