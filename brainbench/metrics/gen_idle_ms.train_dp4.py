"""Milliseconds of rank 0's device idle per data-parallel step inside
its generator, with three more generators on the same host: the traced
window's idle intervals (the complement of the device timeline's busy
intervals) that fall inside rank 0's `gen.item` spans
(synth/engine.py::synth_item; brainfm_tpu_torch/utils/profiling.py),
summed, over the steps completed (one item a rank a step)."""


def _merged(intervals):
    out = []
    for x, y in sorted(intervals):
        if out and x <= out[-1][1]:
            out[-1][1] = max(out[-1][1], y)
        else:
            out.append([x, y])
    return out


def _overlap(p, q):
    """ns shared by two sorted lists of disjoint intervals."""
    i = j = tot = 0
    while i < len(p) and j < len(q):
        tot += max(0, min(p[i][1], q[j][1]) - max(p[i][0], q[j][0]))
        if p[i][1] < q[j][1]:
            i += 1
        else:
            j += 1
    return tot


def read(w):
    from brainfm_tpu_torch.utils import profiling

    spans = getattr(profiling, "SPANS", None)
    units = w.done // int(w.traffic["batch_items"])
    if w.timeline is None or not units or not spans:
        return None
    a, b = w.timeline.t0_ns, w.timeline.t1_ns
    inside = _merged((max(s.t0, a), min(s.t1, b)) for s in list(spans)
                     if s.name == "gen.item" and s.t1 is not None
                     and s.t1 > a and s.t0 < b)
    if not inside:
        return None
    edges = [a] + [x for ab in w.timeline.busy_intervals() for x in ab] + [b]
    idle = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    return _overlap(idle, inside) / 1e6 / units
