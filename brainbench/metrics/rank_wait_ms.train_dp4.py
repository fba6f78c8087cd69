"""Milliseconds per data-parallel step that rank 0's card waits for the
slowest rank: the device timings of rank 0's `step.reduce.wait` spans
(train/step.py _reduce_over_mesh: the all-reduce of the losses, the
step's first collective, which ends when every rank has finished its
forward and backward; CUDA events on the stream at the span's ends,
brainfm_tpu_torch/utils/profiling.py `Span.device_ms`) that start in the
traced window, summed, over the steps completed. Silent where the program
records no such span or times none on the card."""


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
    steps = w.done // int(w.traffic["batch_items"])
    ms = _device_ms(w, "step.reduce.wait")
    return ms / steps if steps and ms is not None else None
