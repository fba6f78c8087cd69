"""Adaptive solver steps per training item: the program's `ode.steps`
counter (ops/ode.py, the dopri5 advection of synth/pathology.py, rejected
steps included, each one host read of its error ratio;
brainfm_tpu_torch/utils/profiling.py), its counts inside the traced
window summed, over the items completed; nothing without the generator's
`gen.item` spans in the window."""


def read(w):
    from brainfm_tpu_torch.utils import profiling

    events = getattr(profiling, "EVENTS", None)
    units = w.done
    if w.timeline is None or not units or not events:
        return None
    a, b = w.timeline.t0_ns, w.timeline.t1_ns
    spans = getattr(profiling, "SPANS", None) or []
    if not any(s.name == "gen.item" and s.t1 is not None and s.t1 > a
               and s.t0 < b for s in list(spans)):
        return None
    return sum(k for t, name, k in list(events)
               if name == "ode.steps" and a <= t <= b) / units
