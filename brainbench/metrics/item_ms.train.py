"""Milliseconds a training item spends in the generator: the harness's
`item` spans (synth_item through train/loop.py::make_batch, K1 and K2),
summed over the window and divided by the items completed."""


def read(w):
    s = w.spans.seconds("item")
    return s * 1e3 / w.done if w.done and s > 0 else None
