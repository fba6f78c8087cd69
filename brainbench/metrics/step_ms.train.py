"""Milliseconds a train step takes (train/step.py: the model's forward
and backward, the criterion, the non-finite check, AdamW): the harness's
`step` spans summed over the window, divided by the steps."""


def read(w):
    s = w.spans.seconds("step")
    steps = w.done // int(w.traffic["batch_items"])
    return s * 1e3 / steps if steps and s > 0 else None
