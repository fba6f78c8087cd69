"""Host syncs per training iteration: the program's `host_syncs` counter
(each place of the generator and the train step where the host waits
for the card: a value read back, a copy from pageable host memory;
brainfm_tpu_torch/utils/profiling.py), its counts inside the traced
window summed, over the iterations completed."""


def read(w):
    from brainfm_tpu_torch.utils import profiling

    events = getattr(profiling, "EVENTS", None)
    units = w.done // int(w.traffic["batch_items"])
    if w.timeline is None or not units or not events:
        return None
    a, b = w.timeline.t0_ns, w.timeline.t1_ns
    n = [k for t, name, k in list(events)
         if name == "host_syncs" and a <= t <= b]
    return sum(n) / units if n else None
