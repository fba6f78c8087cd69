"""Milliseconds of the card's work per served volume in stage 0 of the
two-stage pair (the mask: UNet3D, pathology head, sigmoid): the device
timings of the program's `serve.stage0` spans (models/build.py
twostage_forward; CUDA events on the stream at the span's ends,
brainfm_tpu_torch/utils/profiling.py `Span.device_ms`) that start in the
traced window, summed, over the volumes served. Silent where the program
records no such span or times none on the card."""


def read(w):
    from brainfm_tpu_torch.utils import profiling

    spans = getattr(profiling, "SPANS", None)
    if w.timeline is None or not w.done or not spans:
        return None
    a, b = w.timeline.t0_ns, w.timeline.t1_ns
    ms = [s.device_ms() for s in list(spans)
          if s.name == "serve.stage0" and s.t1 is not None
          and a <= s.t0 < b and hasattr(s, "device_ms")]
    ms = [m for m in ms if m is not None]
    if not ms:
        return None
    return sum(ms) / w.done
