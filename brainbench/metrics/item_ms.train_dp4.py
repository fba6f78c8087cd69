"""Milliseconds rank 0's generator takes for its item of a data-parallel
step, with three more generators on the same host: the harness's `item`
spans (rank 0's go broadcast, then synth_item through
synth/sharded.py::sharded_synth_batch, K1 and K2) summed over the window,
over the steps completed (one item a rank a step)."""


def read(w):
    s = w.spans.seconds("item")
    steps = w.done // int(w.traffic["batch_items"])
    return s * 1e3 / steps if steps and s > 0 else None
