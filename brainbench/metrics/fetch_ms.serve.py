"""Milliseconds a served volume spends in `Inferencer.fetch_outputs`
(infer/api.py: the copies to pinned host memory and the wait for the
card, so the forward's device tail as the host sees it): the program's
`serve.fetch` spans (brainfm_tpu_torch/utils/profiling.py) clipped to the
traced window and summed, over the volumes served."""


def read(w):
    from brainfm_tpu_torch.utils import profiling

    spans = getattr(profiling, "SPANS", None)
    if w.timeline is None or not w.done or not spans:
        return None
    a, b = w.timeline.t0_ns, w.timeline.t1_ns
    inside = [(max(s.t0, a), min(s.t1, b)) for s in list(spans)
              if s.name == "serve.fetch" and s.t1 is not None and s.t1 > a
              and s.t0 < b]
    if not inside:
        return None
    return sum(y - x for x, y in inside) / 1e6 / w.done
