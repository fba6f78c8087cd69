"""The gradient SUM's NCCL all-reduce's share of its link roofline: the
gradient bytes rank 0 all-reduced in the traced window (the program's
`reduce.bytes` counter, train/step.py _all_reduce_flat), at the link's
peak in one direction, over the card time of those all-reduces (rank 0's
`step.reduce.grads` spans, which hold the gradient buckets' all-reduce
calls alone and start after the losses' all-reduce has waited for the
slowest rank; CUDA events, `Span.device_ms`). Whatever algorithm
implements it, an all-reduce moves each card's N bytes out over its links
and N back, so N / peak is a floor of its time and the share cannot pass
100 %. Nothing counted or timed: no reading."""

# one H100 SXM5's NVLink 4 in one direction: 18 links of 25 GB/s (NVIDIA
# H100 data sheet, 900 GB/s bidirectional). The four-card host gives each
# card 18 links (nvidia-smi nvlink -s) and NCCL finds NVLS multicast on
# them, so the cards meet through NVSwitch
NVLINK4_BYTES_PER_S = 450e9


def _device_ms(w, name):
    """The device milliseconds of rank 0's spans `name` that start in the
    traced window, summed; None without any."""
    from brainfm_tpu_torch.utils import profiling

    spans = getattr(profiling, "SPANS", None)
    if w.timeline is None or not spans:
        return None
    a, b = w.timeline.t0_ns, w.timeline.t1_ns
    ms = [s.device_ms() for s in list(spans)
          if s.name == name and s.t1 is not None
          and a <= s.t0 < b and hasattr(s, "device_ms")]
    ms = [m for m in ms if m is not None]
    return sum(ms) if ms else None


def read(w):
    from brainfm_tpu_torch.utils import profiling

    events = getattr(profiling, "EVENTS", None)
    ms = _device_ms(w, "step.reduce.grads")
    if not events or not ms:
        return None
    a, b = w.timeline.t0_ns, w.timeline.t1_ns
    nbytes = sum(k for t, name, k in list(events)
                 if name == "reduce.bytes" and a <= t <= b)
    if nbytes <= 0:
        return None
    return 100.0 * nbytes / NVLINK4_BYTES_PER_S / (ms / 1e3)
