"""Milliseconds of the card's work per data-parallel step in the gradient
SUM's all-reduce: the device timings of rank 0's `step.reduce.grads`
spans (train/step.py _all_reduce_flat: the flat gradient bucket's NCCL
all-reduce, after the losses' all-reduce has waited for the slowest rank;
CUDA events on the stream at the span's ends,
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
    ms = _device_ms(w, "step.reduce.grads")
    return ms / steps if steps and ms is not None else None
